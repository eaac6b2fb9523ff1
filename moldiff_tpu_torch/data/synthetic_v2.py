"""Drug-like synthetic molecules with aromatic chemistry and physical
geometry (a copy of moldiff_tpu/data/synthetic_v2.py, which imports no JAX
but whose package does).

  * aromatic ring systems (benzene/pyridine/pyrimidine/pyrazine, the
    5-ring heteroaromatics with pyrrole-type lone-pair donors, and fused
    6+6 / 6+5 bicyclics) emitted as bond type 4, plus aliphatic rings,
    nitriles and alkynes (type 3);
  * physical per-pattern equilibrium bond lengths (aromatic pair table +
    covalent-radii sums from chem/bond_perception), planar aromatic ring
    systems, law-of-cosines 1-3 angle constraints by hybridisation;
  * sizes ~ N(24.923, 5.516), the GEOM-Drug statistics.

Every emitted molecule passes the sanitize cascade by construction
(rejection-sampled); after 12 rejections the generator falls back to the
v1 generator (synthetic.py). A test holds the copy equal to the original,
molecule for molecule, on one seeded stream.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..chem.bond_perception import expected_length
from ..chem.mol import AROMATIC, Mol, MolError
from ..chem.periodic import DEFAULT_VALENCES, allowed_valences
from ..chem.sanitize import kekulize, sanitize

# GEOM-Drug atom-count statistics
SIZE_MEAN = 24.923464980477522
SIZE_STD = 5.516291901819105

# published aromatic bond lengths (Angstrom), symmetric keys
_AROMATIC_LEN = {
    (6, 6): 1.39, (6, 7): 1.34, (7, 7): 1.35, (6, 8): 1.36,
    (6, 16): 1.71, (7, 16): 1.66, (7, 8): 1.37,
}


def pair_length(zi: int, zj: int, order: int) -> float:
    """Equilibrium bond length for (element, element, order)."""
    if order == AROMATIC:
        v = _AROMATIC_LEN.get((min(zi, zj), max(zi, zj)))
        if v is not None:
            return v
        e1 = expected_length(zi, zj, 1)
        e2 = expected_length(zi, zj, 2)
        if e1 is not None and e2 is not None:
            return 0.5 * (e1 + e2)
        return 1.40
    v = expected_length(zi, zj, order)
    return v if v is not None else 1.50


# ---------------------------------------------------------------------------
# ring templates
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RingTemplate:
    name: str
    zs: Tuple[int, ...]
    bonds: Tuple[Tuple[int, int, int], ...]   # (i, j, order)
    donors: Tuple[int, ...] = ()              # pyrrole-like lone-pair donors
    aromatic: bool = True
    # ring membership per atom (ring size used for interior angles)
    rings: Tuple[Tuple[int, ...], ...] = ()


def _single(name: str, zs: Sequence[int], donors: Sequence[int] = (),
            aromatic: bool = True) -> RingTemplate:
    n = len(zs)
    order = AROMATIC if aromatic else 1
    bonds = tuple((k, (k + 1) % n, order) for k in range(n))
    return RingTemplate(name, tuple(zs), bonds, tuple(donors), aromatic,
                        rings=(tuple(range(n)),))


def _fused(name: str, zs6: Sequence[int], zs2_rest: Sequence[int],
           donors: Sequence[int] = ()) -> RingTemplate:
    """Fuse a second aromatic ring onto edge (0,1) of a 6-ring. The second
    ring is atoms [0, 1, 6, 7, ...] (size = 2 + len(zs2_rest))."""
    n2 = 2 + len(zs2_rest)
    zs = tuple(zs6) + tuple(zs2_rest)
    bonds = [(k, (k + 1) % 6, AROMATIC) for k in range(6)]
    second = [1] + list(range(6, 6 + len(zs2_rest))) + [0]
    for a, b in zip(second[:-1], second[1:]):
        bonds.append((a, b, AROMATIC))
    ring2 = tuple([0, 1] + list(range(6, 6 + len(zs2_rest))))
    assert len(ring2) == n2
    return RingTemplate(name, zs, tuple(bonds), tuple(donors), True,
                        rings=(tuple(range(6)), ring2))


# template library with draw weights; GEOM-Drug is aromatic-dominated, so
# aromatic singles + fused systems outweigh aliphatic rings
_TEMPLATES: List[Tuple[RingTemplate, float]] = [
    (_single("benzene", [6] * 6), 3.2),
    (_single("pyridine", [7, 6, 6, 6, 6, 6]), 1.3),
    (_single("pyrimidine", [7, 6, 7, 6, 6, 6]), 0.5),
    (_single("pyrazine", [7, 6, 6, 7, 6, 6]), 0.25),
    (_single("pyrrole", [7, 6, 6, 6, 6], donors=(0,)), 0.45),
    (_single("imidazole", [7, 6, 7, 6, 6], donors=(0,)), 0.55),
    (_single("pyrazole", [7, 7, 6, 6, 6], donors=(0,)), 0.40),
    (_single("thiophene", [16, 6, 6, 6, 6]), 0.50),
    (_single("furan", [8, 6, 6, 6, 6]), 0.30),
    (_single("thiazole", [16, 6, 7, 6, 6]), 0.35),
    (_single("oxazole", [8, 6, 7, 6, 6]), 0.20),
    (_fused("naphthalene", [6] * 6, [6, 6, 6, 6]), 0.35),
    (_fused("quinoline", [6] * 6, [6, 6, 6, 7]), 0.30),
    (_fused("indole", [6] * 6, [6, 6, 7], donors=(8,)), 0.45),
    (_fused("benzimidazole", [6] * 6, [7, 6, 7], donors=(8,)), 0.30),
    (_fused("benzothiophene", [6] * 6, [6, 6, 16]), 0.18),
    (_fused("benzofuran", [6] * 6, [6, 6, 8]), 0.15),
    (_single("cyclohexane", [6] * 6, aromatic=False), 0.60),
    (_single("cyclopentane", [6] * 5, aromatic=False), 0.30),
    (_single("piperidine", [7, 6, 6, 6, 6, 6], aromatic=False), 0.45),
    (_single("piperazine", [7, 6, 6, 7, 6, 6], aromatic=False), 0.20),
    (_single("morpholine", [8, 6, 6, 7, 6, 6], aromatic=False), 0.25),
    (_single("tetrahydrofuran", [8, 6, 6, 6, 6], aromatic=False), 0.15),
    (_single("pyrrolidine", [7, 6, 6, 6, 6], aromatic=False), 0.30),
]
_TPL_W = np.array([w for _, w in _TEMPLATES])
_TPL_W = _TPL_W / _TPL_W.sum()
_AROM_TPL_IDX = [k for k, (t, _) in enumerate(_TEMPLATES) if t.aromatic]


# -- template geometry (2D) + free valences, computed once and cached -------

_GEOM_CACHE: Dict[str, Tuple[np.ndarray, List[int]]] = {}


def _ring_interior(n: int) -> float:
    return (n - 2) * math.pi / n


def _template_geometry(tpl: RingTemplate) -> Tuple[np.ndarray, List[int]]:
    """(coords [n,2], free_valence [n]) — 2D relaxation to per-edge
    equilibrium lengths + ring interior angles, then kekulized free-valence
    accounting (pyrrole-type N keeps one substitution slot; ring O/S and
    pyridine-type N get none)."""
    if tpl.name in _GEOM_CACHE:
        return _GEOM_CACHE[tpl.name]
    n = len(tpl.zs)
    # init: first ring as a regular polygon, extra atoms fanned outwards
    side = float(np.mean([pair_length(tpl.zs[i], tpl.zs[j], o)
                          for i, j, o in tpl.bonds]))
    r0 = tpl.rings[0]
    R = side / (2.0 * math.sin(math.pi / len(r0)))
    pos = np.zeros((n, 2))
    for k, a in enumerate(r0):
        th = 2.0 * math.pi * k / len(r0)
        pos[a] = (R * math.cos(th), R * math.sin(th))
    if len(tpl.rings) > 1:
        r1 = tpl.rings[1]
        extra = [a for a in r1 if a not in r0]
        # mirror the fused ring across the shared edge (atoms 0 and 1)
        p0, p1 = pos[r1[0]], pos[r1[1]]
        mid = 0.5 * (p0 + p1)
        edge = p1 - p0
        perp = np.array([-edge[1], edge[0]])
        perp /= np.linalg.norm(perp)
        if np.dot(perp, mid) < 0:  # point away from ring-1 centroid (origin)
            perp = -perp
        R2 = side / (2.0 * math.sin(math.pi / len(r1)))
        apo = R2 * math.cos(math.pi / len(r1))
        c2 = mid + perp * apo
        ang0 = math.atan2(p1[1] - c2[1], p1[0] - c2[0])
        ang_p0 = math.atan2(p0[1] - c2[1], p0[0] - c2[0])
        # step AWAY from p0 so the extras wind around the far side of the
        # circle (vertex order on ring 2 is p1, e1, ..., e_{n-2}, p0)
        d = (ang_p0 - ang0 + math.pi) % (2.0 * math.pi) - math.pi
        for k, a in enumerate(extra, start=1):
            th = ang0 - d * k
            pos[a] = (c2[0] + R2 * math.cos(th), c2[1] + R2 * math.sin(th))
    # relax: per-edge equilibrium + 1-3 law-of-cosines at ring interior angle
    # weighted targets: edges are hard (w 1), 1-3 angle targets soft (w 0.3)
    # — with mixed edge lengths a polygon can't satisfy exact lengths AND
    # uniform interior angles; lengths win, angles flex
    targets: Dict[Tuple[int, int], Tuple[float, float]] = {}
    for i, j, o in tpl.bonds:
        targets[(min(i, j), max(i, j))] = (
            pair_length(tpl.zs[i], tpl.zs[j], o), 1.0)
    blen = {k: v[0] for k, v in targets.items()}
    for ring in tpl.rings:
        theta = _ring_interior(len(ring))
        m = len(ring)
        for k in range(m):
            a, b, c = ring[k], ring[(k + 1) % m], ring[(k + 2) % m]
            la = blen[(min(a, b), max(a, b))]
            lb = blen[(min(b, c), max(b, c))]
            d = math.sqrt(la * la + lb * lb - 2 * la * lb * math.cos(theta))
            targets.setdefault((min(a, c), max(a, c)), (d, 0.3))
    for _ in range(800):
        f = np.zeros_like(pos)
        for (i, j), (t, w) in targets.items():
            d = pos[j] - pos[i]
            dist = np.linalg.norm(d) + 1e-9
            corr = 0.5 * w * (dist - t) * d / dist
            f[i] += corr
            f[j] -= corr
        pos += 0.35 * f
    for i, j, o in tpl.bonds:
        got = float(np.linalg.norm(pos[i] - pos[j]))
        want = pair_length(tpl.zs[i], tpl.zs[j], o)
        if abs(got - want) > 0.08:
            raise ValueError(
                f"template {tpl.name} failed to relax: bond {i}-{j} "
                f"{got:.3f} vs {want:.3f}")
    # free valences from the kekulized structure
    m = Mol()
    for z in tpl.zs:
        m.add_atom(z)
    for i, j, o in tpl.bonds:
        m.add_bond(i, j, o)
    kek = kekulize(m, pyrrole_like=set(tpl.donors)) if tpl.aromatic else m
    free = []
    for i in range(n):
        z = tpl.zs[i]
        used = int(round(kek.valence_sum(i)))
        fv = DEFAULT_VALENCES[z][0] - used
        if tpl.aromatic and z in (8, 16):
            fv = 0        # ring O/S: lone-pair donors, no substitution
        if tpl.aromatic and z == 7 and i not in tpl.donors:
            fv = 0        # pyridine-type N
        free.append(max(int(fv), 0))
    _GEOM_CACHE[tpl.name] = (pos, free)
    return pos, free


# ---------------------------------------------------------------------------
# molecule assembly
# ---------------------------------------------------------------------------

_CHAIN_ELEMENTS = [6] * 31 + [7] * 6 + [8] * 9 + [9] * 2 + [16] + [17]


@dataclass
class _Build:
    mol: Mol = field(default_factory=Mol)
    free: List[int] = field(default_factory=list)
    pos: List[np.ndarray] = field(default_factory=list)      # 3D init
    # constraint map: (i<j) -> (target, weight)
    cons: Dict[Tuple[int, int], Tuple[float, float]] = field(default_factory=dict)
    ring_atom: Set[int] = field(default_factory=set)
    sp2: Set[int] = field(default_factory=set)   # has double/aromatic bond
    sp1: Set[int] = field(default_factory=set)   # has triple bond

    def add_atom(self, z: int, pos3: np.ndarray) -> int:
        i = self.mol.add_atom(int(z))
        self.free.append(DEFAULT_VALENCES[int(z)][0])
        self.pos.append(np.asarray(pos3, dtype=np.float64))
        return i

    def attach_dir(self, j: int, rng: np.random.Generator) -> np.ndarray:
        """Initial direction for a new substituent on atom j: away from the
        mean of j's existing neighbors (for a ring atom this is the exocyclic
        in-plane radial direction), plus a little noise. A consistent init
        matters: the constraint solver can shrink a too-wide angle easily but
        cannot rotate a whole arm out of a trapped reflection."""
        nbrs = self.mol.neighbors(j)
        if not nbrs:
            return _rand_unit(rng)
        d = self.pos[j] - np.mean([self.pos[k] for k in nbrs], axis=0)
        nrm = np.linalg.norm(d)
        if nrm < 1e-6:
            return _rand_unit(rng)
        d = d / nrm + rng.normal(scale=0.25, size=3)
        return d / (np.linalg.norm(d) + 1e-12)

    def add_bond(self, i: int, j: int, order: int) -> None:
        self.mol.add_bond(i, j, order)
        use = {1: 1, 2: 2, 3: 3, AROMATIC: 1}[order]
        # aromatic accounting happens in _template_geometry's kekulized free
        self.free[i] -= use
        self.free[j] -= use
        t = pair_length(self.mol.atoms[i].z, self.mol.atoms[j].z, order)
        self.cons[(min(i, j), max(i, j))] = (t, 1.0)
        if order in (2, AROMATIC):
            self.sp2.add(i)
            self.sp2.add(j)
        if order == 3:
            self.sp1.add(i)
            self.sp1.add(j)


def _rand_rotation(rng: np.random.Generator) -> np.ndarray:
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _place_template(b: _Build, tpl: RingTemplate, rng: np.random.Generator,
                    center: np.ndarray) -> List[int]:
    coords2d, free = _template_geometry(tpl)
    rot = _rand_rotation(rng)
    xyz = np.concatenate([coords2d, np.zeros((len(coords2d), 1))], axis=1)
    xyz = xyz @ rot.T + center
    idx = []
    for k, z in enumerate(tpl.zs):
        i = b.add_atom(z, xyz[k])
        b.free[i] = free[k]           # kekulized accounting overrides default
        b.ring_atom.add(i)
        if tpl.aromatic:
            b.sp2.add(i)
        idx.append(i)
    for i, j, o in tpl.bonds:
        b.mol.add_bond(idx[i], idx[j], o)
    # geometry constraints: aromatic/fused systems pin ALL intra-system pairs
    # (planarity is rigid given the full distance matrix); aliphatic rings
    # pin edges + 1-3 only, so they keep their physical pucker freedom
    n = len(idx)
    d2 = np.linalg.norm(coords2d[:, None, :] - coords2d[None, :, :], axis=-1)
    if tpl.aromatic:
        for a in range(n):
            for c in range(a + 1, n):
                key = (min(idx[a], idx[c]), max(idx[a], idx[c]))
                w = 1.0 if d2[a, c] < 2.9 else 0.6
                b.cons[key] = (float(d2[a, c]), w)
    else:
        for i, j, o in tpl.bonds:
            key = (min(idx[i], idx[j]), max(idx[i], idx[j]))
            b.cons[key] = (float(d2[i, j]), 1.0)
        for ring in tpl.rings:
            m = len(ring)
            for k in range(m):
                a, c = ring[k], ring[(k + 2) % m]
                key = (min(idx[a], idx[c]), max(idx[a], idx[c]))
                b.cons.setdefault(key, (float(d2[a, c]), 0.6))
    return idx


def _graph_distance(mol: Mol, i: int, j: int, cap: int = 7) -> int:
    if i == j:
        return 0
    seen = {i}
    frontier = [i]
    d = 0
    while frontier and d < cap:
        d += 1
        nxt = []
        for u in frontier:
            for v in mol.neighbors(u):
                if v == j:
                    return d
                if v not in seen:
                    seen.add(v)
                    nxt.append(v)
        frontier = nxt
    return cap + 1


def _angle_for(b: _Build, k: int) -> float:
    if k in b.sp1:
        return math.pi
    if k in b.sp2:
        return 2.0 * math.pi / 3.0
    return math.radians(109.47)


def _add_angle_constraints(b: _Build) -> None:
    mol = b.mol
    for k in range(mol.num_atoms):
        nbrs = mol.neighbors(k)
        theta = _angle_for(b, k)
        for a in range(len(nbrs)):
            for c in range(a + 1, len(nbrs)):
                i, j = nbrs[a], nbrs[c]
                key = (min(i, j), max(i, j))
                if key in b.cons:
                    continue
                la = b.cons[(min(i, k), max(i, k))][0]
                lb = b.cons[(min(j, k), max(j, k))][0]
                d = math.sqrt(la * la + lb * lb
                              - 2 * la * lb * math.cos(theta))
                b.cons[key] = (d, 0.5)


def _layout(b: _Build, rng: np.random.Generator, iters: int = 250) -> np.ndarray:
    n = b.mol.num_atoms
    pos = np.stack(b.pos).astype(np.float64)
    pos += rng.normal(scale=0.02, size=pos.shape)   # break planar degeneracy
    T = np.zeros((n, n))
    W = np.zeros((n, n))
    for (i, j), (t, w) in b.cons.items():
        T[i, j] = T[j, i] = t
        W[i, j] = W[j, i] = w
    for it in range(iters):
        diff = pos[:, None, :] - pos[None, :, :]
        dist = np.linalg.norm(diff, axis=-1) + 1e-9
        np.fill_diagonal(dist, np.inf)
        unit = diff / dist[..., None]
        # constrained springs (guard W==0 rows where dist is inf on the diag)
        spring = np.where(W > 0, dist - T, 0.0) * W
        f = -np.sum(spring[..., None] * unit, axis=1) * 0.5
        # unconstrained repulsion below 2.4 A
        rep = np.where((W == 0) & (dist < 2.4), 2.4 - dist, 0.0)
        np.fill_diagonal(rep, 0.0)
        f += np.sum(rep[..., None] * unit, axis=1) * 0.25
        step = 0.45 * (1.0 - it / iters) + 0.05
        pos += step * np.clip(f, -1.0, 1.0)
    # polish: vectorized Jacobi constraint projection (position-based
    # dynamics) — converges the stiff ring/angle network once the topology is
    # untangled; all-pairs-at-once + np.add.at keeps the per-molecule cost
    # O(passes * |cons|) in numpy instead of a pure-Python inner loop
    keys = np.array(list(b.cons.keys()), dtype=np.int64)
    vals = np.array(list(b.cons.values()), dtype=np.float64)
    ii, jj = keys[:, 0], keys[:, 1]
    tt, ww = vals[:, 0], np.minimum(vals[:, 1], 1.0)
    # degree-averaged Jacobi: an atom shared by many constraints receives the
    # MEAN of its corrections, not the sum — plain Jacobi projection diverges
    # on the stiff all-pair aromatic networks (measured: attempts/mol 1.8 -> 1.0)
    deg = (np.bincount(ii, minlength=n) + np.bincount(jj, minlength=n))
    deg = np.maximum(deg, 1).astype(np.float64)[:, None]
    for _ in range(150):
        d = pos[ii] - pos[jj]
        dist = np.sqrt(np.einsum("ij,ij->i", d, d)) + 1e-12
        corr = (0.9 * ww * (dist - tt) / dist)[:, None] * d
        acc = np.zeros_like(pos)
        np.subtract.at(acc, ii, corr)
        np.add.at(acc, jj, corr)
        pos += acc / deg
    pos -= pos.mean(axis=0)
    return pos


def random_molecule_v2(
    rng: np.random.Generator, n_atoms: Optional[int] = None,
) -> Mol:
    """Random sanitizable drug-like molecule with aromatic systems, triple
    bonds and physical geometry. Rejection-samples until sanitize passes."""
    for _ in range(12):
        try:
            return _generate(rng, n_atoms)
        except (MolError, _RetryError):
            continue
    # deterministic fallback: a plain benzene keeps the pipeline alive
    from .synthetic import random_molecule
    return random_molecule(rng, n_atoms)


class _RetryError(Exception):
    pass


def _generate(rng: np.random.Generator, n_atoms: Optional[int]) -> Mol:
    if n_atoms is None:
        n_atoms = int(np.clip(rng.normal(SIZE_MEAN, SIZE_STD), 8, 38))
    b = _Build()

    # -- ring systems --------------------------------------------------------
    n_sys = int(np.clip(round(rng.normal(n_atoms / 10.5, 0.8)), 0, 3))
    if rng.random() < 0.04:
        n_sys = 0
    systems: List[List[int]] = []
    for k in range(n_sys):
        budget = n_atoms - b.mol.num_atoms
        if budget < 5 + (2 if k + 1 < n_sys else 0):
            break
        while True:
            ti = int(rng.choice(len(_TEMPLATES), p=_TPL_W))
            tpl = _TEMPLATES[ti][0]
            if len(tpl.zs) <= budget:
                break
        center = np.array([4.2 * k, 0.4 * k, 0.0]) + rng.normal(scale=0.3, size=3)
        systems.append(_place_template(b, tpl, rng, center))

    # -- connect ring systems (direct biaryl bond or 1-atom linker) ----------
    for k in range(1, len(systems)):
        prev_atoms = [i for s in systems[:k] for i in s if b.free[i] > 0]
        cur_atoms = [i for i in systems[k] if b.free[i] > 0]
        if not prev_atoms or not cur_atoms:
            raise _RetryError
        a = int(rng.choice(cur_atoms))
        c = int(rng.choice(prev_atoms))
        if rng.random() < 0.55 and b.mol.num_atoms < n_atoms:
            z = int(rng.choice([6, 6, 6, 8, 7]))
            mid = 0.5 * (b.pos[a] + b.pos[c]) + rng.normal(scale=0.3, size=3)
            x = b.add_atom(z, mid)
            b.add_bond(a, x, 1)
            b.add_bond(x, c, 1)
        else:
            b.add_bond(a, c, 1)

    # -- seed atom when there are no rings ------------------------------------
    if b.mol.num_atoms == 0:
        b.add_atom(6, np.zeros(3))

    # -- grow acyclic substituents/chains -------------------------------------
    did_nitrile = False
    did_alkyne = False
    while b.mol.num_atoms < n_atoms:
        cands = [j for j in range(b.mol.num_atoms) if b.free[j] > 0]
        if not cands:
            break
        j = int(cands[rng.integers(len(cands))])
        at = b.pos[j] + b.attach_dir(j, rng) * 1.5
        budget = n_atoms - b.mol.num_atoms
        # triple bonds stay rare, like GEOM-Drug (~10% of molecules carry a
        # nitrile, ~4% an alkyne): per-step odds over ~12 growth steps
        if (not did_nitrile and budget >= 2 and b.free[j] >= 1
                and rng.random() < 0.012):
            c = b.add_atom(6, at)
            b.add_bond(j, c, 1)
            nx = b.add_atom(7, b.pos[c] + b.attach_dir(c, rng) * 1.16)
            b.add_bond(c, nx, 3)
            did_nitrile = True
            continue
        if (not did_alkyne and budget >= 2 and b.free[j] >= 1
                and j not in b.ring_atom and rng.random() < 0.004):
            c1 = b.add_atom(6, at)
            b.add_bond(j, c1, 1)
            c2 = b.add_atom(6, b.pos[c1] + b.attach_dir(c1, rng) * 1.2)
            b.add_bond(c1, c2, 3)
            did_alkyne = True
            continue
        z = int(_CHAIN_ELEMENTS[rng.integers(len(_CHAIN_ELEMENTS))])
        i = b.add_atom(z, at)
        order = 1
        if (b.free[j] >= 2 and b.free[i] >= 2 and j not in b.ring_atom
                and j not in b.sp2 and j not in b.sp1 and rng.random() < 0.18):
            order = 2
        b.add_bond(i, j, order)

    # -- extra aliphatic ring closures among chain atoms ----------------------
    chain = [k for k in range(b.mol.num_atoms)
             if k not in b.ring_atom and b.free[k] > 0 and k not in b.sp1]
    n_close = int(rng.binomial(max(len(chain) // 7, 0), 0.35))
    for _ in range(n_close):
        chain = [k for k in chain if b.free[k] > 0]
        if len(chain) < 2:
            break
        i, j = rng.choice(chain, size=2, replace=False)
        i, j = int(i), int(j)
        if b.mol.bond_between(i, j) is not None:
            continue
        gd = _graph_distance(b.mol, i, j)
        if not (4 <= gd <= 6):
            continue
        b.add_bond(i, j, 1)

    # -- geometry --------------------------------------------------------------
    _add_angle_constraints(b)
    pos = _layout(b, rng)
    if not np.isfinite(pos).all():
        raise _RetryError
    # reject gross geometry failures (clashed/unsatisfiable layouts)
    for (i, j), (t, w) in b.cons.items():
        if w >= 1.0:
            d = float(np.linalg.norm(pos[i] - pos[j]))
            if abs(d - t) > 0.35:
                raise _RetryError
    for k, a in enumerate(b.mol.atoms):
        a.pos = pos[k]

    sanitize(b.mol)
    if b.mol.num_atoms < 6:
        raise _RetryError
    return b.mol


def _rand_unit(rng: np.random.Generator) -> np.ndarray:
    v = rng.normal(size=3)
    return v / (np.linalg.norm(v) + 1e-12)
