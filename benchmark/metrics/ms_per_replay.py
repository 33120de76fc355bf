"""Wall milliseconds of the unprofiled restart, its captures left out, over
its replays."""


def read(run):
    t = run.plain["timing"]
    if not t.get("replays"):
        return None
    return 1e3 * (run.plain["seconds"] - t.get("capture_s", 0.0)) / t["replays"]
