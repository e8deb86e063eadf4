"""Mesh and point-cloud file readers: OFF, OBJ, PLY (ascii and binary
little-endian), a copy of the JAX package's `ogmm_tpu/data/mesh.py`.

The OFF reader tolerates ModelNet's broken headers (the counts glued onto
the 'OFF' line). The PLY reader is self-contained numpy (no `plyfile`) and
covers the vertex clouds 7-Scenes ships.
"""
from __future__ import annotations

import numpy as np


class Mesh:
    def __init__(self, vertices: np.ndarray, faces=None):
        self.vertex_array = np.asarray(vertices, dtype=np.float64)
        self.faces = faces if faces is not None else []

    def clone(self):
        return Mesh(self.vertex_array.copy(), list(self.faces))


class Mesh2Points:
    """Transform: Mesh -> float32 (N, 3) vertex array (numpy: the pipeline
    runs on the host)."""

    def __call__(self, mesh: Mesh) -> np.ndarray:
        return mesh.clone().vertex_array.astype(np.float32)


def offread(path: str) -> Mesh:
    """OFF reader with the ModelNet broken-header tolerance: some ModelNet
    files glue the counts onto the 'OFF' line."""
    with open(path) as f:
        first = f.readline().strip()
        if first.startswith('OFF') and len(first) > 3:
            counts = first[3:].split()          # 'OFF490 518 0' style
        elif first == 'OFF':
            counts = f.readline().split()
        else:
            raise ValueError(f"{path}: not an OFF file")
        nv, nf = int(counts[0]), int(counts[1])
        verts = np.array([list(map(float, f.readline().split()[:3]))
                          for _ in range(nv)])
        faces = []
        for _ in range(nf):
            parts = f.readline().split()
            if parts:
                faces.append(list(map(int, parts[1:1 + int(parts[0])])))
    return Mesh(verts, faces)


def objread(path: str) -> Mesh:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith('v '):
                verts.append(list(map(float, line.split()[1:4])))
            elif line.startswith('f '):
                idx = [int(tok.split('/')[0]) - 1 for tok in line.split()[1:]]
                faces.append(idx)
    return Mesh(np.array(verts), faces)


_PLY_DTYPES = {
    'char': 'i1', 'int8': 'i1', 'uchar': 'u1', 'uint8': 'u1',
    'short': 'i2', 'int16': 'i2', 'ushort': 'u2', 'uint16': 'u2',
    'int': 'i4', 'int32': 'i4', 'uint': 'u4', 'uint32': 'u4',
    'float': 'f4', 'float32': 'f4', 'double': 'f8', 'float64': 'f8',
}


def plyread(path: str) -> Mesh:
    """Minimal PLY reader (vertex x/y/z; ascii or binary_little_endian)."""
    with open(path, 'rb') as f:
        if f.readline().strip() != b'ply':
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []           # [(name, count, [(prop_name, dtype_str)])]
        cur = None
        while True:
            line = f.readline().decode('ascii', 'replace').strip()
            if line.startswith('format'):
                fmt = line.split()[1]
            elif line.startswith('comment') or line.startswith('obj_info'):
                continue
            elif line.startswith('element'):
                _, name, count = line.split()
                cur = (name, int(count), [])
                elements.append(cur)
            elif line.startswith('property'):
                parts = line.split()
                if parts[1] == 'list':
                    cur[2].append((parts[-1], 'list', parts[2], parts[3]))
                else:
                    cur[2].append((parts[-1], _PLY_DTYPES[parts[1]]))
            elif line == 'end_header':
                break

        verts = None
        for name, count, props in elements:
            if any(p[1] == 'list' for p in props):
                break  # face lists: stop — we only need vertices for clouds
            if fmt == 'ascii':
                rows = np.loadtxt([f.readline() for _ in range(count)],
                                  dtype=np.float64, ndmin=2)
                table = {p[0]: rows[:, i] for i, p in enumerate(props)}
            else:
                dt = np.dtype([(p[0], '<' + p[1]) for p in props])
                raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt,
                                    count=count)
                table = {p[0]: raw[p[0]] for p in props}
            if name == 'vertex':
                verts = np.stack([table['x'], table['y'], table['z']],
                                 axis=-1).astype(np.float64)
        if verts is None:
            raise ValueError(f"{path}: no vertex element found")
    return Mesh(verts)


def meshread(path: str) -> Mesh:
    lower = path.lower()
    if lower.endswith('.off'):
        return offread(path)
    if lower.endswith('.obj'):
        return objread(path)
    if lower.endswith('.ply'):
        return plyread(path)
    raise ValueError(f"unsupported mesh format: {path}")
