"""Graph replays of the unprofiled restart per kept iteration (the program's
``timing["replays"]``): NUTS leaves and the Gibbs body, or ChEES's L."""


def read(run):
    n = run.plain["timing"].get("replays")
    return None if n is None else n / run.plain["iters"]
