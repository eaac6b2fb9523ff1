"""Canonical SMILES generation.

First-party replacement for RDKit's MolToSmiles, which the reference uses
for uniqueness/novelty bookkeeping and disconnect detection ('.' in SMILES,
`reference/scripts/sample_drug3d.py:152-156`). Canonicalization is a
Morgan-style iterative refinement of atom invariants followed by a
deterministic DFS with ring-closure digits; aromatic systems are written in
lowercase (kekulization-invariant), so equal graphs give equal strings.

This is NOT guaranteed to match RDKit's canonical form — it is canonical
*within* this framework (same molecule -> same string), which is what the
uniqueness/novelty/dedup metrics require.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

from .mol import AROMATIC, Mol
from .periodic import ORGANIC_SUBSET, SYMBOL_TO_Z
from .sanitize import perceive_aromaticity

BOND_SYMBOL = {1: "", 2: "=", 3: "#"}


def _initial_invariant(mol: Mol, i: int) -> Tuple:
    a = mol.atoms[i]
    return (
        a.z,
        a.charge,
        mol.degree(i),
        int(round(mol.valence_sum(i) * 2)),
        mol.implicit_h(i),
        int(a.aromatic),
    )


def canonical_ranks(mol: Mol) -> List[int]:
    """Morgan-style refinement: ranks stable under neighborhood hashing."""
    n = mol.num_atoms
    inv = [_initial_invariant(mol, i) for i in range(n)]
    ranks = _ranks_from_keys(inv)
    for _ in range(n + 2):
        new_keys = []
        for i in range(n):
            nb = sorted(
                (ranks[j], mol.bonds[mol._adj[i][j]].order) for j in mol._adj[i]
            )
            new_keys.append((ranks[i], tuple(nb)))
        new_ranks = _ranks_from_keys(new_keys)
        if new_ranks == ranks:
            break
        ranks = new_ranks
    # break remaining ties deterministically (by current rank, then index)
    if len(set(ranks)) < n:
        order = sorted(range(n), key=lambda i: (ranks[i], i))
        final = [0] * n
        for r, i in enumerate(order):
            final[i] = r
        ranks = final
    return ranks


def _ranks_from_keys(keys: List) -> List[int]:
    sorted_unique = sorted(set(keys))
    lookup = {k: r for r, k in enumerate(sorted_unique)}
    return [lookup[k] for k in keys]


def _atom_token(mol: Mol, i: int) -> str:
    a = mol.atoms[i]
    sym = a.symbol
    arom = a.aromatic and a.z in (5, 6, 7, 8, 15, 16)
    body = sym.lower() if arom else sym
    n_h = mol.implicit_h(i)

    needs_bracket = (
        a.z not in ORGANIC_SUBSET
        or a.charge != 0
        or (arom and a.z == 7 and n_h > 0)  # pyrrole [nH]
    )
    if not needs_bracket:
        return body
    h_part = "" if n_h == 0 else ("H" if n_h == 1 else f"H{n_h}")
    if a.charge == 0:
        c_part = ""
    elif a.charge == 1:
        c_part = "+"
    elif a.charge == -1:
        c_part = "-"
    else:
        c_part = f"{a.charge:+d}"
    return f"[{body}{h_part}{c_part}]"


def _bond_token(mol: Mol, i: int, j: int) -> str:
    b = mol.bond_between(i, j)
    if b.order == AROMATIC:
        return ""  # implicit between aromatic atoms
    if b.order == 1 and mol.atoms[i].aromatic and mol.atoms[j].aromatic:
        return "-"  # explicit single between two aromatic atoms (biphenyl)
    return BOND_SYMBOL[b.order]


def mol_to_smiles(mol: Mol, canonical: bool = True) -> str:
    """Write (canonical) SMILES; disconnected components joined by '.'."""
    perceive_aromaticity(mol)
    ranks = canonical_ranks(mol) if canonical else list(range(mol.num_atoms))

    parts = []
    comps = mol.connected_components()
    comps.sort(key=lambda c: min(ranks[i] for i in c))
    visited_global: Set[int] = set()
    for comp in comps:
        root = min(comp, key=lambda i: ranks[i])
        parts.append(_write_component(mol, root, ranks))
        visited_global.update(comp)
    return ".".join(parts)


def _write_component(mol: Mol, root: int, ranks: List[int]) -> str:
    """Two passes: (1) deterministic DFS -> tree children + back edges in
    visit order; (2) emit tokens with ring-closure digits."""
    # pass 1: iterative DFS, children ordered by canonical rank
    order: List[int] = []
    tree_children: Dict[int, List[int]] = {}
    back_edges: List[Tuple[int, int]] = []  # (first-visited u, second v)
    visited: Set[int] = set()
    seen_edges: Set[Tuple[int, int]] = set()

    def dfs(u: int, parent: int):
        visited.add(u)
        order.append(u)
        tree_children[u] = []
        for v in sorted(mol._adj[u], key=lambda j: (ranks[j], j)):
            if v == parent:
                continue
            key = (min(u, v), max(u, v))
            if v in visited:
                if key not in seen_edges:
                    seen_edges.add(key)
                    back_edges.append((v, u))  # v was visited first
            else:
                seen_edges.add(key)
                tree_children[u].append(v)
                dfs(v, u)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        dfs(root, -1)
    finally:
        sys.setrecursionlimit(old_limit)

    # assign ring-closure digits in order of the *second* endpoint's visit
    pos_in_order = {a: k for k, a in enumerate(order)}
    back_edges.sort(key=lambda e: (pos_in_order[e[1]], pos_in_order[e[0]]))
    ring_digits: Dict[int, List[Tuple[int, int]]] = {}  # atom -> [(digit, other)]
    for d, (u, v) in enumerate(back_edges, start=1):
        ring_digits.setdefault(u, []).append((d, v))
        ring_digits.setdefault(v, []).append((d, u))

    # pass 2: emit
    out: List[str] = []

    def emit(u: int):
        out.append(_atom_token(mol, u))
        for d, v in sorted(ring_digits.get(u, ())):
            # bond symbol printed at the closing (second) occurrence
            if pos_in_order[v] < pos_in_order[u]:
                out.append(_bond_token(mol, u, v) + _digit_token(d))
            else:
                out.append(_digit_token(d))
        kids = tree_children[u]
        for idx, v in enumerate(kids):
            btok = _bond_token(mol, u, v)
            if idx < len(kids) - 1:
                out.append("(" + btok)
                emit(v)
                out.append(")")
            else:
                out.append(btok)
                emit(v)

    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        emit(root)
    finally:
        sys.setrecursionlimit(old_limit)
    return "".join(out)


def _digit_token(d: int) -> str:
    return str(d) if d < 10 else f"%{d:02d}"


# ---------------------------------------------------------------------------
# SMILES parsing (reader)
# ---------------------------------------------------------------------------

_ORGANIC_TWO = ("Cl", "Br")
_ORGANIC_ONE = ("B", "C", "N", "O", "P", "S", "F", "I")
_AROMATIC_ORGANIC = ("b", "c", "n", "o", "p", "s")
_BOND_CHARS = {"-": 1, "=": 2, "#": 3, ":": AROMATIC, "/": 1, "\\": 1}
_DEFAULT = -1  # provisional order for "no bond symbol written"


class SmilesError(ValueError):
    """Raised on malformed or unsupported SMILES input."""


def mol_from_smiles(s: str, sanitize_mol: bool = True) -> Mol:
    """Parse a SMILES string into a :class:`Mol` (first-party MolFromSmiles).

    Supported: the organic subset + aromatic lowercase atoms, bracket atoms
    ``[<isotope>? <symbol> @|@@? H<n>? +/-<n>? :map?]`` (isotope, chirality
    and atom maps are accepted and ignored), bonds ``- = # : / \\`` (the
    directional bonds parse as single — 3D comes from conformers here, not
    cis/trans flags), branches, ring closures ``1``-``9`` and ``%nn``, and
    ``.``-separated components. Bracket hydrogen counts become explicit H
    overrides; organic-subset atoms fill implicit Hs by default valence
    exactly like molecules built through :meth:`Mol.add_atom`.

    A bond written WITHOUT a symbol between two aromatic atoms resolves to
    AROMATIC when it closes inside a ring and to single otherwise (so
    ``c1ccccc1c1ccccc1`` is biphenyl), matching the common toolkit reading.

    ``sanitize_mol=True`` runs the full sanitize cascade (valence check +
    aromatic-ring check + kekulizability) and raises ``MolError`` on
    chemistry the framework rejects; pass False to inspect raw parses.
    """
    from .mol import MolError  # local: avoid cycle at import time
    from .sanitize import sanitize

    mol = Mol()
    prev: List[int] = []        # branch stack; top = current attach atom
    cur = -1                    # current atom (-1 = none yet / after '.')
    pending: int | None = None  # explicit bond symbol awaiting its atom
    ring_open: Dict[int, Tuple[int, int | None]] = {}
    default_bonds: List[int] = []
    i, n = 0, len(s)

    def add_bond(a: int, b: int, order: int | None) -> None:
        o = _DEFAULT if order is None else order
        idx = mol.add_bond(a, b, 1 if o == _DEFAULT else o)
        if o == _DEFAULT:
            default_bonds.append(idx)

    def attach(idx: int) -> None:
        nonlocal cur, pending
        if cur >= 0:
            add_bond(cur, idx, pending)
        elif pending is not None:
            raise SmilesError(f"bond with no preceding atom at {i}")
        pending = None
        cur = idx

    while i < n:
        ch = s[i]
        if ch.isspace():
            break  # SMILES line may carry a trailing name/comment
        if ch == "(":
            if cur < 0:
                raise SmilesError("branch before any atom")
            prev.append(cur)
            i += 1
        elif ch == ")":
            if not prev:
                raise SmilesError("unmatched ')'")
            cur = prev.pop()
            i += 1
        elif ch in _BOND_CHARS:
            if pending is not None:
                raise SmilesError(f"two bond symbols in a row at {i}")
            pending = _BOND_CHARS[ch]
            i += 1
        elif ch == ".":
            if pending is not None:
                raise SmilesError("bond before '.'")
            cur = -1
            i += 1
        elif ch.isdigit() or ch == "%":
            if cur < 0:
                raise SmilesError("ring closure before any atom")
            if ch == "%":
                if i + 2 >= n or not s[i + 1:i + 3].isdigit():
                    raise SmilesError(f"bad %nn ring closure at {i}")
                num = int(s[i + 1:i + 3])
                i += 3
            else:
                num = int(ch)
                i += 1
            if num in ring_open:
                a, o_open = ring_open.pop(num)
                if o_open is not None and pending is not None \
                        and o_open != pending:
                    raise SmilesError(f"ring {num} bond order mismatch")
                order = o_open if o_open is not None else pending
                if a == cur:
                    raise SmilesError(f"ring {num} closes on itself")
                add_bond(a, cur, order)
                pending = None
            else:
                ring_open[num] = (cur, pending)
                pending = None
        elif ch == "[":
            j = s.find("]", i)
            if j < 0:
                raise SmilesError("unterminated bracket atom")
            idx = _parse_bracket(mol, s[i + 1:j])
            attach(idx)
            i = j + 1
        else:
            two = s[i:i + 2]
            if two in _ORGANIC_TWO:
                idx = mol.add_atom(SYMBOL_TO_Z[two])
                attach(idx)
                i += 2
            elif ch in _ORGANIC_ONE:
                idx = mol.add_atom(SYMBOL_TO_Z[ch])
                attach(idx)
                i += 1
            elif ch in _AROMATIC_ORGANIC:
                idx = mol.add_atom(SYMBOL_TO_Z[ch.upper()])
                mol.atoms[idx].aromatic = True
                attach(idx)
                i += 1
            else:
                raise SmilesError(f"unexpected character {ch!r} at {i}")

    if ring_open:
        raise SmilesError(f"unclosed ring closures: {sorted(ring_open)}")
    if prev:
        raise SmilesError("unclosed branch '('")
    if pending is not None:
        raise SmilesError("dangling bond symbol at end of input")
    if mol.num_atoms == 0:
        raise SmilesError("empty SMILES")

    # resolve default bonds: aromatic only when both ends are aromatic AND
    # the bond sits in a ring (biphenyl's inter-ring default bond -> single)
    ring_bonds = mol.ring_bond_ids()
    for bidx in default_bonds:
        b = mol.bonds[bidx]
        if (bidx in ring_bonds and mol.atoms[b.i].aromatic
                and mol.atoms[b.j].aromatic):
            b.order = AROMATIC

    if sanitize_mol:
        sanitize(mol)
    return mol


def _parse_bracket(mol: Mol, body: str) -> int:
    """Parse one bracket-atom body (between '[' and ']'); returns atom idx."""
    k, m = 0, len(body)
    while k < m and body[k].isdigit():  # isotope — accepted, ignored
        k += 1
    aromatic = False
    if k < m and body[k:k + 2] in ("Cl", "Br", "Se", "Si", "As"):
        sym = body[k:k + 2]
        k += 2
    elif k < m and body[k].isupper():
        # one-letter element, optionally followed by a lowercase that forms
        # a known two-letter symbol (Na, Zn, ...)
        if k + 1 < m and body[k:k + 2] in SYMBOL_TO_Z:
            sym = body[k:k + 2]
            k += 2
        else:
            sym = body[k]
            k += 1
    elif k < m and body[k] in "bcnops":
        sym = body[k].upper()
        aromatic = True
        k += 1
    elif k < m and body[k:k + 2] == "se":
        sym = "Se"
        aromatic = True
        k += 2
    else:
        raise SmilesError(f"bad bracket atom [{body}]")
    if sym == "H":
        raise SmilesError(
            "explicit hydrogen atoms ([H]) are unsupported — this framework "
            "models heavy atoms with implicit hydrogens"
        )
    if sym not in SYMBOL_TO_Z:
        raise SmilesError(f"unknown element {sym!r} in [{body}]")

    while k < m and body[k] == "@":  # chirality — accepted, ignored
        k += 1

    hcount = 0
    if k < m and body[k] == "H":
        k += 1
        d = ""
        while k < m and body[k].isdigit():
            d += body[k]
            k += 1
        hcount = int(d) if d else 1

    charge = 0
    while k < m and body[k] in "+-":
        sign = 1 if body[k] == "+" else -1
        k += 1
        d = ""
        while k < m and body[k].isdigit():
            d += body[k]
            k += 1
        charge += sign * (int(d) if d else 1)

    if k < m and body[k] == ":":  # atom map — accepted, ignored
        k += 1
        while k < m and body[k].isdigit():
            k += 1
    if k != m:
        raise SmilesError(f"trailing junk in bracket atom [{body}]")

    idx = mol.add_atom(SYMBOL_TO_Z[sym], charge=charge)
    a = mol.atoms[idx]
    a.aromatic = aromatic
    # bracket atoms carry NO implicit hydrogens beyond the written count
    a.num_explicit_h = hcount
    return idx
