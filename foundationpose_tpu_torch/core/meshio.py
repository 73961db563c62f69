"""Triangle-mesh container and IO (host-side numpy).

The port's own copy of foundationpose_tpu/core/meshio.py (same functions,
same behaviour; the port imports nothing of the JAX package).

Replaces the reference's trimesh dependency (mesh loading at main.py:126, mesh
tensors at src/Utils.py:104-130, diameter at src/Utils.py:559-574, voxel
downsampling at src/estimater.py:60) with a small self-contained
implementation: OBJ (+MTL texture) and PLY (ascii / binary_little_endian,
BOP-style per-vertex texture coords) readers and writers, vertex normals,
the SVD diameter, and vertex-clustering decimation used to bound triangle
counts for the rasterizer. Textures are read and written through the port's
PNG codec (``io/png.py``); other image formats need PIL. (Voxel downsampling
is not needed by the ported paths yet.)
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # (V,3) float64
    faces: np.ndarray  # (F,3) int32
    vertex_normals: np.ndarray | None = None  # (V,3)
    uv: np.ndarray | None = None  # (V,2) per-vertex texture coords, origin top-left NOT flipped
    texture: np.ndarray | None = None  # (Ht,Wt,3) uint8
    vertex_colors: np.ndarray | None = None  # (V,3) uint8

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, dtype=np.float64).reshape(-1, 3)
        self.faces = np.asarray(self.faces, dtype=np.int32).reshape(-1, 3)
        if self.vertex_normals is None and len(self.faces):
            self.vertex_normals = compute_vertex_normals(self.vertices, self.faces)

    def copy(self):
        return Mesh(
            self.vertices.copy(),
            self.faces.copy(),
            None if self.vertex_normals is None else self.vertex_normals.copy(),
            None if self.uv is None else self.uv.copy(),
            None if self.texture is None else self.texture.copy(),
            None if self.vertex_colors is None else self.vertex_colors.copy(),
        )

    @property
    def bounds(self):
        return np.stack([self.vertices.min(axis=0), self.vertices.max(axis=0)])

    def translated(self, offset):
        m = self.copy()
        m.vertices = m.vertices + np.asarray(offset).reshape(1, 3)
        return m


def compute_face_normals(vertices, faces):
    v = np.asarray(vertices)
    f = np.asarray(faces)
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    return n  # area-weighted (unnormalized)


def is_watertight(mesh: "Mesh") -> bool:
    """True when every undirected edge is shared by exactly two faces with
    opposite orientation (closed, consistently-wound surface). Used to decide
    whether backface culling is exact for this mesh."""
    f = np.asarray(mesh.faces, dtype=np.int64)
    if len(f) == 0:
        return False
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    # directed-edge keys; a consistently wound closed mesh has each directed
    # edge exactly once and its reverse exactly once
    n = int(max(f.max() + 1, 1))
    key = edges[:, 0] * n + edges[:, 1]
    rkey = edges[:, 1] * n + edges[:, 0]
    if len(np.unique(key)) != len(key):
        return False
    return bool(np.isin(key, rkey).all())


def compute_vertex_normals(vertices, faces):
    """Area-weighted vertex normals."""
    fn = compute_face_normals(vertices, faces)
    vn = np.zeros_like(np.asarray(vertices, dtype=np.float64))
    for k in range(3):
        np.add.at(vn, np.asarray(faces)[:, k], fn)
    norms = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.maximum(norms, 1e-12)


def compute_mesh_diameter(mesh=None, model_pts=None, n_sample=10000, rng=None):
    """Mesh diameter.

    With a mesh: the reference's SVD-extent formula (Utils.py:559-565):
    rotate vertices into principal axes and take the bbox diagonal.
    With points: max pairwise distance over a random subsample
    (Utils.py:567-574).
    """
    if mesh is not None:
        pts = np.asarray(mesh.vertices)
        centered = pts  # reference does not center; follow it
        u, s, vh = np.linalg.svd(centered, full_matrices=False)
        proj = u * s  # == centered @ vh.T
        return float(np.linalg.norm(proj.max(axis=0) - proj.min(axis=0)))
    pts = np.asarray(model_pts)
    if n_sample is not None and len(pts) > n_sample:
        rng = rng or np.random.default_rng(0)
        pts = pts[rng.choice(len(pts), size=n_sample, replace=False)]
    d = np.linalg.norm(pts[None] - pts[:, None], axis=-1)
    return float(d.max())


def decimate_vertex_clustering(mesh: Mesh, max_faces: int) -> Mesh:
    """Bound the face count by clustering vertices on a uniform grid and
    collapsing. Used to keep the rasterizer's triangle axis small & static;
    attribute (color/uv/normal) carried by cluster average."""
    if len(mesh.faces) <= max_faces:
        return mesh
    lo, hi = mesh.bounds
    extent = float(np.max(hi - lo))
    # Binary search the voxel size that lands under max_faces.
    size_lo, size_hi = extent / 512, extent
    out = mesh
    for _ in range(20):
        size = (size_lo * size_hi) ** 0.5
        cand = _cluster_once(mesh, size)
        if len(cand.faces) > max_faces:
            size_lo = size
        else:
            out = cand
            size_hi = size
    if len(out.faces) > max_faces:
        out = _cluster_once(mesh, size_hi)
    return out


def _cluster_once(mesh: Mesh, voxel_size: float) -> Mesh:
    keys = np.floor(mesh.vertices / voxel_size).astype(np.int64)
    uniq, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    V = len(uniq)

    def pool(attr, dtype=np.float64):
        if attr is None:
            return None
        acc = np.zeros((V, attr.shape[1]), dtype=np.float64)
        np.add.at(acc, inv, np.asarray(attr, dtype=np.float64))
        return (acc / counts[:, None]).astype(dtype)

    verts = pool(mesh.vertices)
    faces = inv[mesh.faces]
    keep = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[keep].astype(np.int32)
    vc = pool(mesh.vertex_colors)
    vc = None if vc is None else np.clip(vc, 0, 255).astype(np.uint8)
    uv = pool(mesh.uv)
    return Mesh(verts, faces, None, uv, mesh.texture, vc)


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

def load_obj(path):
    """Wavefront OBJ with optional MTL texture. Face-varying vt/vn are unified
    by splitting vertices on distinct (v, vt, vn) triples (what trimesh does,
    so mesh.visual.uv lines up with mesh.faces as assumed at Utils.py:115-117)."""
    positions, uvs, normals = [], [], []
    corner_index: dict[tuple, int] = {}
    out_pos, out_uv, out_nrm, faces = [], [], [], []
    mtl_texture = None

    base = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(parts[1]), float(parts[2])])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                corners = []
                for spec in parts[1:]:
                    toks = spec.split("/")
                    vi = int(toks[0])
                    vi = vi - 1 if vi > 0 else len(positions) + vi
                    ti = ni = -1
                    if len(toks) > 1 and toks[1]:
                        ti = int(toks[1])
                        ti = ti - 1 if ti > 0 else len(uvs) + ti
                    if len(toks) > 2 and toks[2]:
                        ni = int(toks[2])
                        ni = ni - 1 if ni > 0 else len(normals) + ni
                    key = (vi, ti, ni)
                    if key not in corner_index:
                        corner_index[key] = len(out_pos)
                        out_pos.append(positions[vi])
                        out_uv.append(uvs[ti] if ti >= 0 else [0.0, 0.0])
                        out_nrm.append(normals[ni] if ni >= 0 else None)
                    corners.append(corner_index[key])
                for k in range(1, len(corners) - 1):  # fan triangulation
                    faces.append([corners[0], corners[k], corners[k + 1]])
            elif tag == "mtllib" and len(parts) > 1:
                mtl_texture = _load_mtl_texture(os.path.join(base, parts[1]))

    has_uv = len(uvs) > 0
    has_nrm = all(n is not None for n in out_nrm) and len(normals) > 0
    mesh = Mesh(
        np.asarray(out_pos, dtype=np.float64),
        np.asarray(faces, dtype=np.int32),
        np.asarray(out_nrm, dtype=np.float64) if has_nrm else None,
        np.asarray(out_uv, dtype=np.float64) if has_uv else None,
        mtl_texture,
        None,
    )
    if mesh.texture is None:
        mesh.uv = mesh.uv if has_uv else None
    return mesh


def _load_mtl_texture(mtl_path):
    if not os.path.exists(mtl_path):
        return None
    base = os.path.dirname(os.path.abspath(mtl_path))
    with open(mtl_path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if parts and parts[0] == "map_Kd" and len(parts) > 1:
                img_path = os.path.join(base, parts[-1])
                if os.path.exists(img_path):
                    from foundationpose_tpu_torch.io.datareader import _imread_rgb

                    return _imread_rgb(img_path)
    return None


def save_obj(path, mesh: Mesh):
    with open(path, "w") as f:
        if mesh.texture is not None and mesh.uv is not None:
            mtl = os.path.splitext(os.path.basename(path))[0]
            f.write(f"mtllib {mtl}.mtl\n")
        for i, v in enumerate(mesh.vertices):
            if mesh.vertex_colors is not None:
                c = mesh.vertex_colors[i] / 255.0
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if mesh.uv is not None:
            for t in mesh.uv:
                f.write(f"vt {t[0]} {t[1]}\n")
        for face in mesh.faces:
            if mesh.uv is not None:
                f.write("f " + " ".join(f"{i + 1}/{i + 1}" for i in face) + "\n")
            else:
                f.write("f " + " ".join(str(i + 1) for i in face) + "\n")
    if mesh.texture is not None and mesh.uv is not None:
        from foundationpose_tpu_torch.io import png

        base, _ = os.path.splitext(path)
        png.write_png(base + ".png", np.asarray(mesh.texture, np.uint8))
        with open(base + ".mtl", "w") as f:
            f.write(f"newmtl material_0\nKd 1 1 1\nmap_Kd {os.path.basename(base)}.png\n")


# ---------------------------------------------------------------------------
# PLY (BOP model format: ascii or binary_little_endian, optional per-vertex
# colors / texture_u,texture_v + TextureFile comment)
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path):
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end:]

    fmt = "ascii"
    elements = []  # list of (name, count, [(prop_name, type, is_list, list_count_type)])
    texture_file = None
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "comment" and len(parts) >= 3 and parts[1] == "TextureFile":
            texture_file = parts[2]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], True, parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], False, None))

    parsed = {}
    if fmt == "ascii":
        tokens = body.decode("ascii", errors="replace").split()
        pos = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                row = {}
                for pname, ptype, is_list, _ in props:
                    if is_list:
                        n = int(float(tokens[pos])); pos += 1
                        row[pname] = [float(tokens[pos + k]) for k in range(n)]
                        pos += n
                    else:
                        row[pname] = float(tokens[pos]); pos += 1
                rows.append(row)
            parsed[name] = rows
    elif fmt == "binary_little_endian":
        pos = 0
        for name, count, props in elements:
            fixed = all(not p[2] for p in props)
            if fixed:
                fmt_str = "<" + "".join(_PLY_TYPES[p[1]][0] for p in props)
                size = struct.calcsize(fmt_str)
                arr = np.frombuffer(body, dtype=np.dtype([(p[0], "<" + _np_code(p[1])) for p in props]), count=count, offset=pos)
                pos += size * count
                parsed[name] = arr
            else:
                rows = []
                for _ in range(count):
                    row = {}
                    for pname, ptype, is_list, ltype in props:
                        if is_list:
                            lc, lsz = _PLY_TYPES[ltype]
                            n = struct.unpack_from("<" + lc, body, pos)[0]
                            pos += lsz
                            pc, psz = _PLY_TYPES[ptype]
                            row[pname] = list(struct.unpack_from("<" + pc * n, body, pos))
                            pos += psz * n
                        else:
                            pc, psz = _PLY_TYPES[ptype]
                            row[pname] = struct.unpack_from("<" + pc, body, pos)[0]
                            pos += psz
                    rows.append(row)
                parsed[name] = rows
    else:
        raise ValueError(f"unsupported PLY format {fmt}")

    vert = parsed["vertex"]
    if isinstance(vert, np.ndarray):
        get = lambda k: np.asarray(vert[k], dtype=np.float64) if k in vert.dtype.names else None
    else:
        names = set(vert[0].keys()) if vert else set()
        get = lambda k: (
            np.asarray([r[k] for r in vert], dtype=np.float64) if k in names else None
        )
    xyz = np.stack([get("x"), get("y"), get("z")], axis=-1)
    normals = None
    if get("nx") is not None:
        normals = np.stack([get("nx"), get("ny"), get("nz")], axis=-1)
    colors = None
    if get("red") is not None:
        colors = np.stack([get("red"), get("green"), get("blue")], axis=-1).astype(np.uint8)
    uv = None
    if get("texture_u") is not None:
        uv = np.stack([get("texture_u"), get("texture_v")], axis=-1)
    elif get("s") is not None:
        uv = np.stack([get("s"), get("t")], axis=-1)

    face_rows = parsed.get("face", [])
    faces = []
    for row in face_rows:
        idx = row["vertex_indices"] if "vertex_indices" in row else row.get("vertex_index")
        idx = [int(i) for i in idx]
        for k in range(1, len(idx) - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])
    faces = np.asarray(faces, dtype=np.int32) if faces else np.zeros((0, 3), np.int32)

    texture = None
    if texture_file is not None:
        img_path = os.path.join(os.path.dirname(os.path.abspath(path)), texture_file)
        if os.path.exists(img_path):
            from foundationpose_tpu_torch.io.datareader import _imread_rgb

            texture = _imread_rgb(img_path)
    return Mesh(xyz, faces, normals, uv, texture, colors)


def _np_code(ply_type):
    return {"b": "i1", "B": "u1", "h": "i2", "H": "u2", "i": "i4", "I": "u4", "f": "f4", "d": "f8"}[_PLY_TYPES[ply_type][0]]


def save_ply(path, mesh: Mesh):
    """ASCII PLY: positions, optional vertex colours, triangles."""
    with open(path, "wb") as f:
        lines = ["ply", "format ascii 1.0", f"element vertex {len(mesh.vertices)}"]
        lines += ["property float x", "property float y", "property float z"]
        if mesh.vertex_colors is not None:
            lines += ["property uchar red", "property uchar green", "property uchar blue"]
        lines += [f"element face {len(mesh.faces)}",
                  "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(lines) + "\n").encode())
        for i, v in enumerate(mesh.vertices):
            row = f"{v[0]} {v[1]} {v[2]}"
            if mesh.vertex_colors is not None:
                c = mesh.vertex_colors[i]
                row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write((row + "\n").encode())
        for face in mesh.faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode())


def load_mesh(path):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".ply":
        return load_ply(path)
    raise ValueError(f"unsupported mesh format: {ext}")


# ---------------------------------------------------------------------------
# Primitives (tests / synthetic scenes)
# ---------------------------------------------------------------------------

def make_box(extents=(1.0, 1.0, 1.0)):
    e = np.asarray(extents, dtype=np.float64) / 2.0
    corners = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], dtype=np.float64
    ) * e
    # 12 triangles, outward-facing CCW
    quads = [
        (0, 1, 3, 2), (4, 6, 7, 5),  # -x, +x
        (0, 4, 5, 1), (2, 3, 7, 6),  # -y, +y
        (0, 2, 6, 4), (1, 5, 7, 3),  # -z, +z
    ]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    return Mesh(corners, np.asarray(faces, dtype=np.int32))


def make_icosphere_mesh(subdivisions=2, radius=1.0):
    from foundationpose_tpu_torch.core.icosphere import icosphere

    verts, faces = icosphere(subdivisions, radius)
    return Mesh(verts, faces.astype(np.int32))


def make_cylinder(radius=0.5, height=1.0, n_seg=48):
    """Closed cylinder along +z, outward-CCW winding (z-axis continuous
    rotational symmetry — the evaluation suite's symmetric-object class,
    matching the reference's YCB-V cylinder overrides, datareader.py:483-507)."""
    ang = np.arange(n_seg) / n_seg * 2 * np.pi
    ring = np.stack([np.cos(ang) * radius, np.sin(ang) * radius], axis=-1)
    top = np.concatenate([ring, np.full((n_seg, 1), height / 2)], axis=-1)
    bot = np.concatenate([ring, np.full((n_seg, 1), -height / 2)], axis=-1)
    verts = np.concatenate(
        [top, bot, [[0, 0, height / 2]], [[0, 0, -height / 2]]]
    )
    ct, cb = 2 * n_seg, 2 * n_seg + 1
    faces = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        faces += [[i, n_seg + i, n_seg + j], [i, n_seg + j, j]]  # side
        faces += [[ct, i, j], [cb, n_seg + j, n_seg + i]]  # caps
    return Mesh(verts, np.asarray(faces, dtype=np.int32))
