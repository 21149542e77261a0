"""The whole step's share of the chip's peak: the operations of a step
(htbench.reckon: projection + SH, K1, K2, loss and Adam over the views of
the step profiled after the window) over the time of a step in the
window's untraced rounds (their host-clock seconds between synchronises
over their steps), as a share of 67 TFLOP/s."""

from htbench import reckon


def read(run):
    r = run.get("reckon")
    if not r or not run.get("plain_steps"):
        return None
    step_s = run["plain_s"] / run["plain_steps"]
    return 100.0 * r["profiled_work"]["step"]["flops"] / step_s \
        / reckon.PEAK_FLOPS
