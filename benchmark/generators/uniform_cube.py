"""Points uniform in the unit cube [0, 1)^d (config 2's source points),
``points`` of them in ``dimensions`` columns (3 unless the configuration
says), drawn from the seed. A kernel sum has no data values: ``values``
is None."""


def points_and_values(cell, rng):
    return rng.random((cell.config["points"], cell.config.get("dimensions", 3))), None
