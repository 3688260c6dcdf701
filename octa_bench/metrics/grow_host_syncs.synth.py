"""Device-to-host reads ``Greenhouse.host_syncs`` counts in a growth batch,
mean over the window's growths."""


def read(rec):
    h = rec["host_syncs"]
    return sum(h) / len(h)
