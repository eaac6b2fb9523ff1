"""First-party SMARTS-subset engine: parser + subgraph matcher.

Replaces the slice of RDKit's SMARTS machinery that the reference's
evaluation stack depends on (`reference/utils/scoring_func.py:28-87`
Crippen/alerts typing, `utils/evaluation.py:86-94` fr_* counters). Supports:

  atoms     C N O S P F I B Cl Br, aromatic c n o s p, wildcards * a A
  brackets  [..] with primitives: #<z>, symbol, a, A, *, R / R<n> / r / r<n>,
            D<n>, X<n>, H / H<n>, v<n>, +<n> / -<n> (and ++ / --),
            recursive $(<smarts>)
  logic     ! (not), & (high-AND), , (OR), ; (low-AND); implicit & between
            adjacent primitives
  bonds     - = # : ~ (any) @ (ring) and the SMARTS default
            (single-or-aromatic); ! negation of a single bond primitive
  topology  branches (...), ring closures 1-9 and %nn

Not supported (documented): disconnected patterns '.', atom maps,
directional bonds, isotopes, stereo, 'h' (implicit-H-only counts — all our
hydrogens are implicit, so H covers it).

Matching semantics follow RDKit ``GetSubstructMatches(uniquify=True)``:
matches that map the same set of molecule atoms are reported once.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .mol import AROMATIC, Mol
from .periodic import SYMBOL_TO_Z
from .sanitize import perceive_aromaticity

_ORGANIC_ALIPHATIC = ("Cl", "Br", "B", "C", "N", "O", "S", "P", "F", "I")
_ORGANIC_AROMATIC = ("c", "n", "o", "s", "p")


# -- query AST ---------------------------------------------------------------

@dataclass
class Prim:
    """One atom primitive test."""
    kind: str               # 'z','arom','aliph','any','ring_count','ring',
                            # 'ring_size','degree','conn','hcount','valence',
                            # 'charge','recursive'
    value: object = None
    negate: bool = False


@dataclass
class AtomExpr:
    """Nested boolean expression over primitives.

    op: 'prim' | 'not' | 'and' | 'or'; for 'prim' ``prim`` is set, otherwise
    ``args`` holds sub-expressions.
    """
    op: str
    prim: Optional[Prim] = None
    args: List["AtomExpr"] = field(default_factory=list)


@dataclass
class QueryBond:
    a: int
    b: int
    # spec: None = default single-or-aromatic; int order; 'any'; 'ring'
    spec: object = None
    negate: bool = False


@dataclass
class Query:
    atoms: List[AtomExpr]
    bonds: List[QueryBond]
    adj: Dict[int, Dict[int, int]]  # atom -> {atom: bond idx}


class SmartsError(ValueError):
    pass


# -- parser ------------------------------------------------------------------

class _Parser:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def take(self) -> str:
        ch = self.peek()
        self.i += 1
        return ch

    def error(self, msg: str):
        raise SmartsError(f"{msg} at col {self.i} in {self.s!r}")

    # ---- top level ----

    def parse(self) -> Query:
        atoms: List[AtomExpr] = []
        bonds: List[QueryBond] = []
        adj: Dict[int, Dict[int, int]] = {}
        ring_open: Dict[str, Tuple[int, object, bool]] = {}
        stack: List[int] = []
        prev = -1
        pending: Tuple[object, bool] = (None, False)
        pending_set = False

        def add_bond(a: int, b: int, spec, neg):
            bonds.append(QueryBond(a, b, spec, neg))
            k = len(bonds) - 1
            adj.setdefault(a, {})[b] = k
            adj.setdefault(b, {})[a] = k

        while self.i < len(self.s):
            ch = self.peek()
            if ch == "(":
                self.take()
                if prev < 0:
                    self.error("branch before first atom")
                stack.append(prev)
            elif ch == ")":
                self.take()
                if not stack:
                    self.error("unbalanced )")
                prev = stack.pop()
            elif ch in "-=#:~@!":
                spec, neg = self.parse_bond()
                pending, pending_set = (spec, neg), True
            elif ch.isdigit() or ch == "%":
                label = self.parse_ring_label()
                if prev < 0:
                    self.error("ring closure before first atom")
                if label in ring_open:
                    a, spec0, neg0 = ring_open.pop(label)
                    spec, neg = pending if pending_set else (spec0, neg0)
                    add_bond(a, prev, spec, neg)
                else:
                    ring_open[label] = (
                        prev, *(pending if pending_set else (None, False))
                    )
                pending, pending_set = (None, False), False
            elif ch == ".":
                self.error("disconnected patterns ('.') not supported")
            else:
                expr = self.parse_atom()
                atoms.append(expr)
                idx = len(atoms) - 1
                adj.setdefault(idx, {})
                if prev >= 0:
                    spec, neg = pending if pending_set else (None, False)
                    add_bond(prev, idx, spec, neg)
                prev = idx
                pending, pending_set = (None, False), False
        if ring_open:
            self.error(f"unclosed ring labels {sorted(ring_open)}")
        if stack:
            self.error("unbalanced (")
        if not atoms:
            self.error("empty pattern")
        return Query(atoms, bonds, adj)

    def parse_bond(self) -> Tuple[object, bool]:
        neg = False
        if self.peek() == "!":
            self.take()
            neg = True
        ch = self.take()
        table = {"-": 1, "=": 2, "#": 3, ":": AROMATIC, "~": "any", "@": "ring"}
        if ch not in table:
            self.error(f"bad bond char {ch!r}")
        return table[ch], neg

    def parse_ring_label(self) -> str:
        ch = self.take()
        if ch == "%":
            return self.take() + self.take()
        return ch

    # ---- atoms ----

    def parse_atom(self) -> AtomExpr:
        ch = self.peek()
        if ch == "[":
            self.take()
            expr = self.parse_expr()
            if self.take() != "]":
                self.error("expected ]")
            return expr
        # bare organic-subset atom
        for sym in _ORGANIC_ALIPHATIC:
            if self.s.startswith(sym, self.i):
                self.i += len(sym)
                return _and(
                    _prim("z", SYMBOL_TO_Z[sym]), _prim("aliph")
                )
        if ch in _ORGANIC_AROMATIC:
            self.take()
            return _and(_prim("z", SYMBOL_TO_Z[ch.upper()]), _prim("arom"))
        if ch == "*":
            self.take()
            return _prim_expr(Prim("any"))
        if ch == "a":
            self.take()
            return _prim_expr(Prim("arom"))
        if ch == "A":
            self.take()
            return _prim_expr(Prim("aliph"))
        self.error(f"bad atom start {ch!r}")

    def parse_expr(self) -> AtomExpr:
        # precedence: ! > & (implicit) > , > ;
        def parse_low() -> AtomExpr:
            terms = [parse_or()]
            while self.peek() == ";":
                self.take()
                terms.append(parse_or())
            return terms[0] if len(terms) == 1 else AtomExpr("and", args=terms)

        def parse_or() -> AtomExpr:
            terms = [parse_and()]
            while self.peek() == ",":
                self.take()
                terms.append(parse_and())
            return terms[0] if len(terms) == 1 else AtomExpr("or", args=terms)

        def parse_and() -> AtomExpr:
            terms = [parse_not()]
            while True:
                if self.peek() == "&":
                    self.take()
                    terms.append(parse_not())
                elif self.peek() not in ("", "]", ";", ",", ")"):
                    terms.append(parse_not())  # implicit &
                else:
                    break
            return terms[0] if len(terms) == 1 else AtomExpr("and", args=terms)

        def parse_not() -> AtomExpr:
            if self.peek() == "!":
                self.take()
                return AtomExpr("not", args=[parse_not()])
            return self.parse_primitive()

        return parse_low()

    def parse_number(self, default=None):
        start = self.i
        while self.peek().isdigit():
            self.take()
        if self.i == start:
            return default
        return int(self.s[start:self.i])

    def parse_primitive(self) -> AtomExpr:
        ch = self.peek()
        if ch == "#":
            self.take()
            z = self.parse_number()
            if z is None:
                self.error("expected number after #")
            return _prim_expr(Prim("z", z))
        if ch == "$":
            self.take()
            if self.take() != "(":
                self.error("expected ( after $")
            depth, start = 1, self.i
            while depth:
                c = self.take()
                if c == "":
                    self.error("unclosed $(")
                depth += (c == "(") - (c == ")")
            sub = self.s[start:self.i - 1]
            return _prim_expr(Prim("recursive", parse(sub)))
        if ch == "*":
            self.take()
            return _prim_expr(Prim("any"))
        if ch == "R":
            self.take()
            return _prim_expr(Prim("ring_count", self.parse_number()))
        if ch == "r":
            self.take()
            return _prim_expr(Prim("ring_size", self.parse_number()))
        if ch == "D":
            self.take()
            return _prim_expr(Prim("degree", self.parse_number(1)))
        if ch == "X":
            self.take()
            return _prim_expr(Prim("conn", self.parse_number(1)))
        if ch == "H":
            self.take()
            return _prim_expr(Prim("hcount", self.parse_number(1)))
        if ch == "v":
            self.take()
            return _prim_expr(Prim("valence", self.parse_number(1)))
        if ch in "+-":
            sign = 1 if ch == "+" else -1
            self.take()
            n = 1
            while self.peek() == ch:  # ++ / --
                self.take()
                n += 1
            explicit = self.parse_number()
            if explicit is not None:
                n = explicit
            return _prim_expr(Prim("charge", sign * n))
        if ch == "a":
            self.take()
            return _prim_expr(Prim("arom"))
        if ch == "A":
            self.take()
            return _prim_expr(Prim("aliph"))
        # element symbol: two-letter first, aromatic lowercase, then upper
        for sym in ("Cl", "Br", "Si", "Se", "Na", "Li", "Mg", "Ca", "Fe",
                    "Zn", "Cu", "Mn", "Al", "As"):
            if self.s.startswith(sym, self.i):
                self.i += len(sym)
                return _and(_prim("z", SYMBOL_TO_Z[sym]), _prim("aliph"))
        if ch in "cnosp":
            self.take()
            return _and(_prim("z", SYMBOL_TO_Z[ch.upper()]), _prim("arom"))
        if ch.isupper() and ch in SYMBOL_TO_Z:
            self.take()
            return _and(_prim("z", SYMBOL_TO_Z[ch]), _prim("aliph"))
        self.error(f"bad primitive {ch!r}")


def _prim(kind, value=None) -> AtomExpr:
    return AtomExpr("prim", prim=Prim(kind, value))


def _prim_expr(p: Prim) -> AtomExpr:
    return AtomExpr("prim", prim=p)


def _and(*exprs: AtomExpr) -> AtomExpr:
    return AtomExpr("and", args=list(exprs))


def parse(s: str) -> Query:
    return _Parser(s).parse()


# -- evaluation --------------------------------------------------------------

class _MolView:
    """Cached per-mol ring/aromaticity tables for matching."""

    def __init__(self, mol: Mol):
        perceive_aromaticity(mol)
        self.mol = mol
        rings = mol.ring_info()
        n = mol.num_atoms
        self.ring_count = [0] * n
        self.ring_sizes: List[Set[int]] = [set() for _ in range(n)]
        self.ring_bonds: Set[int] = set()
        for ring in rings:
            k = len(ring)
            for t, a in enumerate(ring):
                self.ring_count[a] += 1
                self.ring_sizes[a].add(k)
                b = mol._adj[a].get(ring[(t + 1) % k])
                if b is not None:
                    self.ring_bonds.add(b)


def _atom_matches(view: _MolView, i: int, expr: AtomExpr) -> bool:
    mol = view.mol
    if expr.op == "and":
        return all(_atom_matches(view, i, e) for e in expr.args)
    if expr.op == "or":
        return any(_atom_matches(view, i, e) for e in expr.args)
    if expr.op == "not":
        return not _atom_matches(view, i, expr.args[0])
    p = expr.prim
    a = mol.atoms[i]
    if p.kind == "any":
        return True
    if p.kind == "z":
        return a.z == p.value
    if p.kind == "arom":
        return a.aromatic
    if p.kind == "aliph":
        return not a.aromatic
    if p.kind == "ring_count":
        if p.value is None:
            return view.ring_count[i] > 0
        return view.ring_count[i] == p.value
    if p.kind == "ring_size":
        if p.value is None:
            return view.ring_count[i] > 0
        return p.value in view.ring_sizes[i]
    if p.kind == "degree":
        return mol.degree(i) == p.value
    if p.kind == "hcount":
        return mol.implicit_h(i) == p.value
    if p.kind == "conn":
        return mol.degree(i) + mol.implicit_h(i) == p.value
    if p.kind == "valence":
        import numpy as np

        v = mol.valence_sum(i) + mol.implicit_h(i)
        return int(np.ceil(v - 1e-9)) == p.value
    if p.kind == "charge":
        return a.charge == p.value
    if p.kind == "recursive":
        return bool(_match_rooted(view, p.value, i))
    raise SmartsError(f"unknown primitive {p.kind}")


def _bond_matches(view: _MolView, bond_idx: int, qb: QueryBond) -> bool:
    order = view.mol.bonds[bond_idx].order
    spec = qb.spec
    if spec is None:
        ok = order in (1, AROMATIC)
    elif spec == "any":
        ok = True
    elif spec == "ring":
        ok = bond_idx in view.ring_bonds
    else:
        ok = order == spec
    return (not ok) if qb.negate else ok


def _dfs_order(q: Query) -> List[Tuple[int, int]]:
    """Visit order as (atom, parent_atom) pairs (parent -1 for the root),
    plus the list of 'extra' bonds (ring closures) checked lazily."""
    seen = [False] * len(q.atoms)
    order: List[Tuple[int, int]] = []
    stack = [(0, -1)]
    while stack:
        u, parent = stack.pop()
        if seen[u]:
            continue
        seen[u] = True
        order.append((u, parent))
        for v in q.adj.get(u, {}):
            if not seen[v]:
                stack.append((v, u))
    if not all(seen):
        raise SmartsError("pattern has disconnected components")
    return order


def _match_rooted(view: _MolView, q: Query, root_atom: int) -> bool:
    """Does a match exist with query atom 0 mapped to ``root_atom``?"""
    return _backtrack(view, q, {0: root_atom}, _dfs_order(q), 1, None)


def _backtrack(view, q, assign: Dict[int, int], order, depth,
               results: Optional[List[Tuple[int, ...]]]) -> bool:
    mol = view.mol
    if depth == len(order):
        # verify all bonds (incl. ring closures not on the DFS tree)
        for qb in q.bonds:
            bi = mol._adj[assign[qb.a]].get(assign[qb.b])
            if bi is None or not _bond_matches(view, bi, qb):
                return False
        if results is None:
            return True
        results.append(tuple(assign[k] for k in range(len(q.atoms))))
        return True
    qa, qparent = order[depth]
    found = False
    candidates = (
        mol._adj[assign[qparent]].keys() if qparent >= 0
        else range(mol.num_atoms)
    )
    used = set(assign.values())
    for cand in candidates:
        if cand in used:
            continue
        if qparent >= 0:
            bi = mol._adj[assign[qparent]][cand]
            if not _bond_matches(view, bi, q.bonds[q.adj[qa][qparent]]):
                continue
        if not _atom_matches(view, cand, q.atoms[qa]):
            continue
        assign[qa] = cand
        ok = _backtrack(view, q, assign, order, depth + 1, results)
        del assign[qa]
        if ok:
            found = True
            if results is None:
                return True
    return found


MolView = _MolView  # public alias: reusable per-mol cache for match_at loops


def find_matches(mol: Mol, pattern) -> List[Tuple[int, ...]]:
    """All matches, uniquified like RDKit GetSubstructMatches(uniquify=True):
    one match per distinct set of molecule atoms."""
    q = parse(pattern) if isinstance(pattern, str) else pattern
    view = _MolView(mol)
    order = _dfs_order(q)
    results: List[Tuple[int, ...]] = []
    for root in range(mol.num_atoms):
        if not _atom_matches(view, root, q.atoms[0]):
            continue
        _backtrack(view, q, {0: root}, order, 1, results)
    seen: Set[frozenset] = set()
    out = []
    for m in results:
        key = frozenset(m)
        if key not in seen:
            seen.add(key)
            out.append(m)
    return out


def count_matches(mol: Mol, pattern) -> int:
    return len(find_matches(mol, pattern))


_PARSE_CACHE: Dict[str, Query] = {}


def parse_cached(pattern: str) -> Query:
    q = _PARSE_CACHE.get(pattern)
    if q is None:
        q = _PARSE_CACHE[pattern] = parse(pattern)
    return q


def match_at(mol: Mol, pattern, atom_idx: int, view: "_MolView" = None) -> bool:
    """Does the pattern match with its FIRST atom mapped to ``atom_idx``?
    (The primitive behind ordered atom-typing tables — Crippen, TPSA.)"""
    q = parse_cached(pattern) if isinstance(pattern, str) else pattern
    if view is None:
        view = _MolView(mol)
    return _atom_matches(view, atom_idx, q.atoms[0]) and _match_rooted(
        view, q, atom_idx
    )


def has_match(mol: Mol, pattern) -> bool:
    q = parse(pattern) if isinstance(pattern, str) else pattern
    view = _MolView(mol)
    order = _dfs_order(q)
    for root in range(mol.num_atoms):
        if _atom_matches(view, root, q.atoms[0]) and _backtrack(
            view, q, {0: root}, order, 1, None
        ):
            return True
    return False
