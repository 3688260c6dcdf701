"""Milliseconds a step of the window outside the loader wait and the step:
the engine loop's post-processing and metrics, window / steps - wait -
step."""


def read(rec):
    n = len(rec["step_s"])
    return 1e3 * (rec["window_s"] / n - sum(rec["wait_s"]) / n
                  - sum(rec["step_s"]) / n)
