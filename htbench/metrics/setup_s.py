"""Set-up: process start to the first timed step (host clock): imports,
the scene, the port's models and the compared first steps."""


def read(run):
    return run["setup_s"]
