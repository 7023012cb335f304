"""A gmsh 4.1 ASCII writer for the port's tests (numpy only, no jax): the
reference's meshes are not in the repository, so the tests that read a
``.msh`` write one from ``models/fem.structured_unit_square_mesh``."""

import numpy as np


def write_msh(path, mesh):
    """``mesh`` as a gmsh 4.1 ASCII file: one node block (tags from 1), one
    block of boundary lines (type 1) and one of triangles (type 2)."""
    n = mesh.n_nodes
    tris = mesh.triangles + 1
    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [0, 2]]])
    bnd = mesh.on_boundary
    # an edge with both ends on the boundary and used by one triangle only
    key, count = np.unique(np.sort(edges, axis=1), axis=0, return_counts=True)
    lines = key[(count == 1) & bnd[key[:, 0] - 1] & bnd[key[:, 1] - 1]]
    with open(path, "w") as fh:
        fh.write("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
        fh.write(f"$Nodes\n1 {n} 1 {n}\n2 1 0 {n}\n")
        fh.write("".join(f"{t}\n" for t in range(1, n + 1)))
        fh.write("".join(f"{float(x)!r} {float(y)!r} 0\n"
                         for x, y in mesh.nodes))
        fh.write("$EndNodes\n")
        m, nl = len(tris), len(lines)
        fh.write(f"$Elements\n2 {nl + m} 1 {nl + m}\n1 1 1 {nl}\n")
        fh.write("".join(f"{k + 1} {a} {b}\n" for k, (a, b) in enumerate(lines)))
        fh.write(f"2 1 2 {m}\n")
        # node order within a triangle as gmsh may give it (unsorted)
        fh.write("".join(f"{nl + k + 1} {c} {a} {b}\n"
                         for k, (a, b, c) in enumerate(tris)))
        fh.write("$EndElements\n")
