"""Loader for HydraAPI .vsgf mesh chunks (the port's own copy of the JAX
package's scene/vsgf.py: the same bytes in, the same MeshData out).

Binary layout (verified against hydra_app/tests/*/data/chunk_*.vsgf and the
<mesh> nodes of statex XML, ref SURVEY.md §2.1 'Mesh upload'):

    uint64 fileSizeInBytes
    uint32 verticesNum
    uint32 indicesNum          (3 * triNum)
    uint32 materialsNum
    uint32 flags
    float4 positions [verticesNum]     (w unused / 1)
    float4 normals   [verticesNum]
    float4 tangents  [verticesNum]     (optional per flags; present in tests)
    float2 texcoords [verticesNum]
    int32  indices   [indicesNum]
    int32  matIndices[indicesNum/3]

The statex XML <mesh> node also carries explicit (offset, bytesize) per
array; when provided we trust the XML (robust to format variations).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

_HEADER = struct.Struct("<QIIII")


@dataclass
class MeshData:
    """Host-side (numpy) mesh, HydraCore-compatible attribute set."""

    pos: np.ndarray  # (V, 4) float32, xyz + pad
    norm: np.ndarray  # (V, 4) float32
    tang: np.ndarray  # (V, 4) float32
    texcoord: np.ndarray  # (V, 2) float32
    indices: np.ndarray  # (T, 3) int32
    mat_indices: np.ndarray  # (T,) int32

    @property
    def num_vertices(self) -> int:
        return int(self.pos.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])


def load_vsgf(data: bytes, xml_arrays: dict | None = None) -> MeshData:
    """Parse a vsgf blob. xml_arrays optionally maps array name ->
    (offset, bytesize) taken from the statex <mesh> node children."""
    file_size, vnum, inum, _mnum, _flags = _HEADER.unpack_from(data, 0)
    tnum = inum // 3

    def arr(name, default_offset, count, dtype, comps):
        if xml_arrays and name in xml_arrays:
            off, bsize = xml_arrays[name]
            n = bsize // (np.dtype(dtype).itemsize * comps)
        else:
            off, n = default_offset, count
        a = np.frombuffer(data, dtype=dtype, count=n * comps, offset=off)
        return a.reshape(n, comps) if comps > 1 else a

    off = _HEADER.size
    pos = arr("positions", off, vnum, np.float32, 4)
    off += vnum * 16
    norm = arr("normals", off, vnum, np.float32, 4)
    off += vnum * 16
    tang = arr("tangents", off, vnum, np.float32, 4)
    off += vnum * 16
    tc = arr("texcoords", off, vnum, np.float32, 2)
    off += vnum * 8
    idx = arr("indices", off, inum, np.int32, 1).reshape(-1, 3)
    off += inum * 4
    mind = arr("matindices", off, tnum, np.int32, 1)

    return MeshData(
        pos=np.ascontiguousarray(pos, np.float32),
        norm=np.ascontiguousarray(norm, np.float32),
        tang=np.ascontiguousarray(tang, np.float32),
        texcoord=np.ascontiguousarray(tc, np.float32),
        indices=np.ascontiguousarray(idx, np.int32),
        mat_indices=np.ascontiguousarray(mind, np.int32),
    )


def make_rect_mesh(half_length: float, half_width: float, mat_id: int) -> MeshData:
    """Procedural rect in XZ plane facing -Y (HydraAPI area-light mesh shape,
    ref PlainLightConverter.cpp area light geometry)."""
    hl, hw = float(half_length), float(half_width)
    pos = np.array(
        [[-hl, 0, -hw, 1], [hl, 0, -hw, 1], [hl, 0, hw, 1], [-hl, 0, hw, 1]],
        np.float32,
    )
    n = np.array([[0, -1, 0, 0]] * 4, np.float32)
    t = np.array([[1, 0, 0, 0]] * 4, np.float32)
    tc = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    mi = np.full((2,), mat_id, np.int32)
    return MeshData(pos, n, t, tc, idx, mi)
