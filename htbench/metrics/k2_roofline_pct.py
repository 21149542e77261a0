"""K2's share of its roofline in the profiled step: the larger of its
operations over 67 TFLOP/s and its bytes over 3.35 TB/s, both counted by
htbench.reckon from the step's views, over K2's device time in that
step."""

from htbench import reckon


def read(run):
    r = run.get("reckon")
    if not r or not r["profiled_layers_s"].get("K2"):
        return None
    return reckon.roofline_pct(r["profiled_work"]["K2"],
                               r["profiled_layers_s"]["K2"])
