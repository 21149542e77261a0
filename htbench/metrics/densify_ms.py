"""Device ms per step of the kernels in the densify layer's ranges
(forward and backward), over the rounds traced by layer
(htbench.trace.LAYERS)."""

LAYER = "densify"


def read(run):
    t = run.get("trace")
    if not t or not t["layer_steps"] or LAYER not in t["layers_s"]:
        return None
    return 1e3 * t["layers_s"][LAYER] / t["layer_steps"]
