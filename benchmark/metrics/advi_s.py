"""Host clock around the ADVI warm start and its draws (synchronized); None
where the cell has no warm start."""


def read(run):
    return run.spans.get("advi_s")
