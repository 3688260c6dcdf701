"""Seconds of one ``Greenhouse.develop_forest`` batch (ended by a
synchronize), mean over the window's growths."""


def read(rec):
    g = rec["grow_s"]
    return sum(g) / len(g)
