"""Fresh signed-distance samples in a shell around a bumpy unit sphere
(``reference/data.py`` ``synthetic_sd``, config 4's generator), drawn from
the seed."""

from benchmark.reference import data


def points_and_values(cell, rng):
    return data.synthetic_sd(cell.config["points"], int(rng.integers(2**63)))
