"""A CSV data set (``data.path``, columns X, Y, Z, value): its rows in an
order drawn from the seed (a configuration with fewer ``points`` than rows
keeps a fixed subset)."""

from benchmark import inputs


def points_and_values(cell, rng):
    pts, vals = inputs.csv_rows(cell)
    order = rng.permutation(cell.config["points"])
    return pts[order], vals[order]
