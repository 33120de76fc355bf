"""The window's graph captures in seconds, as the program times them
(``timing["capture_s"]`` of the unprofiled restart); None off CUDA."""


def read(run):
    return run.plain["timing"].get("capture_s")
