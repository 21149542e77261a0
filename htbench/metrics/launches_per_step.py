"""Kernel launches on the device in the traced window per step (a batched
step once); copies and fills are not launches."""


def read(run):
    t = run.get("trace")
    if not t or not t["steps"]:
        return None
    return t["launches"] / t["steps"]
