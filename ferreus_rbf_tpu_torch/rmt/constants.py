"""Lattice / topology lookup tables for regularised marching tetrahedra.

The tetrahedral sample lattice is a stack of XY planes whose sample points
alternate, so two planes form a rectangular fine grid with half the plane
spacing; each sample point owns 7 of its 14 lattice edges, and those owned
edges span a parallelepiped that is the union of its six owned tetrahedra
(see the diagrams in the reference's ``ferreus_rmt/src/constants.rs``).

The numeric tables (14-edge neighbour masks, flat-hole mask pairs, the
calculation-plane pairs/angles, and the 16-case marching-tetrahedra table)
are data from Treece, Prager & Gee, "Regularised marching tetrahedra:
improved iso-surface extraction", Tables 3-4 and the standard MT
triangulation, laid out for this crate's edge numbering.
"""

import numpy as np

# IJK offsets from a sample point for each of its 14 lattice edges; the
# first 7 are the edges the point owns.
EDGE_DELTAS = np.array(
    [
        [-1, 1, 0],   # 0
        [-2, 0, 0],   # 1
        [-1, -1, 0],  # 2
        [0, 1, -1],   # 3
        [-1, 0, -1],  # 4
        [0, -1, -1],  # 5
        [1, 0, -1],   # 6
        [1, -1, 0],   # 7
        [2, 0, 0],    # 8
        [1, 1, 0],    # 9
        [0, -1, 1],   # 10
        [1, 0, 1],    # 11
        [0, 1, 1],    # 12
        [-1, 0, 1],   # 13
    ],
    dtype=np.int64,
)

# Spanning vectors of the owned parallelepiped.
U = EDGE_DELTAS[0]
V = EDGE_DELTAS[2]
W = EDGE_DELTAS[6]

# Edge indices bounding each parallelepiped face, and the step to the
# neighbouring cell across that face.
FACES = np.array(
    [
        [0, 3, 6, 7],  # across -u
        [1, 2, 5, 4],  # across +u
        [0, 1, 4, 7],  # across -v
        [3, 2, 5, 6],  # across +v
        [0, 1, 2, 3],  # across -w
        [4, 5, 6, 7],  # across +w
    ],
    dtype=np.int64,
)

FACE_DIRS = np.array([-U, U, -V, V, -W, W], dtype=np.int64)

# Opposite edge label (edge e from point p equals edge REVERSE_EDGE[e] from
# the point at p + EDGE_DELTAS[e]).
REVERSE_EDGE = np.array([7, 8, 9, 10, 11, 12, 13, 0, 1, 2, 3, 4, 5, 6], dtype=np.int64)

_DELTA_TO_EDGE = {tuple(d): i for i, d in enumerate(EDGE_DELTAS.tolist())}


def delta_to_edge(delta):
    return _DELTA_TO_EDGE.get(tuple(int(x) for x in delta))


# Table 3: which of the 14 edges neighbour each edge (shared tetrahedra).
NEIGHBOUR_MASKS = np.array(
    [
        0x321A, 0x2015, 0x24B2, 0x0251, 0x006F, 0x00D4, 0x03B8,
        0x0D64, 0x0AC0, 0x1949, 0x2884, 0x3780, 0x2A01, 0x1C07,
    ],
    dtype=np.uint16,
)

# Calculation planes per edge: the two neighbour edges forming each plane
# around the edge, and the corresponding phi angles (section 3.4).
PHI_1 = 0.955316618125
PHI_2 = 1.230959417341

NEIGHBOUR_EDGE_PLANE_PAIRS = [
    [[9, 1], [12, 4], [3, 13]],
    [[0, 2], [4, 13]],
    [[1, 7], [13, 5], [4, 10]],
    [[9, 4], [6, 0]],
    [[0, 5], [3, 2], [1, 6]],
    [[4, 7], [2, 6]],
    [[5, 9], [7, 3], [8, 4]],
    [[10, 6], [5, 11], [2, 8]],
    [[7, 9], [11, 6]],
    [[8, 0], [11, 3], [6, 12]],
    [[2, 11], [13, 7]],
    [[13, 8], [7, 12], [10, 9]],
    [[9, 13], [11, 0]],
    [[0, 10], [12, 2], [11, 1]],
]

NEIGHBOUR_EDGE_PLANE_PHIS = [
    [[PHI_2, PHI_1], [PHI_1, PHI_2], [PHI_1, PHI_2]],
    [[PHI_1, PHI_1], [PHI_1, PHI_1]],
    [[PHI_1, PHI_2], [PHI_2, PHI_1], [PHI_2, PHI_1]],
    [[PHI_1, PHI_1], [PHI_1, PHI_1]],
    [[PHI_2, PHI_1], [PHI_1, PHI_2], [PHI_1, PHI_2]],
    [[PHI_1, PHI_1], [PHI_1, PHI_1]],
    [[PHI_1, PHI_2], [PHI_2, PHI_1], [PHI_1, PHI_2]],
    [[PHI_1, PHI_2], [PHI_1, PHI_2], [PHI_2, PHI_1]],
    [[PHI_1, PHI_1], [PHI_1, PHI_1]],
    [[PHI_1, PHI_2], [PHI_2, PHI_1], [PHI_2, PHI_1]],
    [[PHI_1, PHI_1], [PHI_1, PHI_1]],
    [[PHI_2, PHI_1], [PHI_2, PHI_1], [PHI_1, PHI_2]],
    [[PHI_1, PHI_1], [PHI_1, PHI_1]],
    [[PHI_2, PHI_1], [PHI_1, PHI_2], [PHI_2, PHI_1]],
]

# Table 4: flat-hole detection mask pairs (OA/OB without near intersections,
# OC/OD with them).
FLAT_HOLE_MASKS = np.array(
    [
        [0x0003, 0x2010], [0x0009, 0x0210], [0x0011, 0x000A], [0x0201, 0x1008],
        [0x1001, 0x2200], [0x2001, 0x1002], [0x0006, 0x2010], [0x0012, 0x0005],
        [0x2002, 0x0005], [0x0014, 0x0022], [0x0024, 0x0090], [0x0084, 0x0420],
        [0x0404, 0x2080], [0x2004, 0x0402], [0x0018, 0x0041], [0x0048, 0x0210],
        [0x0208, 0x0041], [0x0030, 0x0044], [0x0050, 0x0028], [0x0060, 0x0090],
        [0x00A0, 0x0044], [0x00C0, 0x0120], [0x0140, 0x0280], [0x0240, 0x0108],
        [0x0180, 0x0840], [0x0480, 0x0804], [0x0880, 0x0500], [0x0300, 0x0840],
        [0x0900, 0x0280], [0x0A00, 0x1100], [0x1200, 0x0801], [0x0C00, 0x2080],
        [0x2400, 0x0804], [0x1800, 0x2200], [0x2800, 0x1400], [0x3000, 0x0801],
    ],
    dtype=np.uint16,
)

ALL14_MASK = (1 << 14) - 1

# Each sample point owns six tetrahedra; each is (point, +edge a, +edge b,
# +edge c) with the edge labels below.
OWNED_TET_EDGES = np.array(
    [
        [0, 4, 1],
        [0, 3, 4],
        [3, 6, 4],
        [1, 4, 2],
        [2, 4, 5],
        [4, 6, 5],
    ],
    dtype=np.int64,
)

# Tetrahedron edges as vertex-index pairs.
TET_EDGE_PAIRS = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)

# 16-case marching-tetrahedra triangle table (right-handed, outward normals);
# entries are tet-edge indices.
MT_TABLE = [
    [],
    [[0, 1, 2]],
    [[0, 4, 3]],
    [[3, 1, 2], [3, 2, 4]],
    [[1, 3, 5]],
    [[5, 2, 0], [5, 0, 3]],
    [[5, 1, 0], [5, 0, 4]],
    [[2, 4, 5]],
    [[2, 5, 4]],
    [[4, 0, 1], [4, 1, 5]],
    [[3, 0, 2], [3, 2, 5]],
    [[1, 5, 3]],
    [[4, 2, 1], [4, 1, 3]],
    [[0, 3, 4]],
    [[0, 2, 1]],
    [],
]
