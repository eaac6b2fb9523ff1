"""SDF / MDL molblock (V2000) reading and writing.

First-party replacement for RDKit's SDMolSupplier/MolToMolFile used by the
reference for dataset ingestion (`reference/utils/dataset.py:106-113`)
and sample output (`scripts/sample_drug3d.py:160-166`). Covers the V2000
subset that GEOM-Drug SDFs use: atom block (coords + symbol + charge), bond
block (order 1/2/3/4), M CHG lines.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, TextIO, Union

from .mol import Mol, MolError
from .periodic import SYMBOL_TO_Z

_CHG_CODE = {3: +1, 2: +2, 1: +3, 5: -1, 6: -2, 7: -3}  # mol-file charge codes
_CHG_CODE_INV = {v: k for k, v in _CHG_CODE.items()}


def mol_to_molblock(mol: Mol, name: str = "", comment: str = "moldiff_tpu") -> str:
    n, m = mol.num_atoms, mol.num_bonds
    lines = [name, f"  {comment}", ""]
    lines.append(
        f"{n:>3d}{m:>3d}  0  0  0  0  0  0  0  0999 V2000"
    )
    for i, a in enumerate(mol.atoms):
        x, y, z = (a.pos if a.pos is not None else (0.0, 0.0, 0.0))
        if max(abs(x), abs(y), abs(z)) >= 1e4:  # "-9999.9999" is 10 cols
            raise MolError(
                f"coordinate overflow for V2000 atom block: ({x}, {y}, {z})"
            )
        lines.append(
            f"{x:>10.4f}{y:>10.4f}{z:>10.4f} {a.symbol:<3s} 0  0  0  0  0  0  0  0  0  0  0  0"
        )
    for b in mol.bonds:
        lines.append(f"{b.i + 1:>3d}{b.j + 1:>3d}{b.order:>3d}  0")
    charged = [(i + 1, a.charge) for i, a in enumerate(mol.atoms) if a.charge]
    for k in range(0, len(charged), 8):
        chunk = charged[k:k + 8]
        line = f"M  CHG{len(chunk):>3d}"
        for idx, chg in chunk:
            line += f"{idx:>4d}{chg:>4d}"
        lines.append(line)
    lines.append("M  END")
    return "\n".join(lines) + "\n"


def molblock_to_mol(block: str) -> Mol:
    lines = block.splitlines()
    if len(lines) < 4:
        raise MolError("molblock too short")
    counts = lines[3]
    try:
        n = int(counts[0:3])
        m = int(counts[3:6])
    except ValueError as e:
        raise MolError(f"bad counts line: {counts!r}") from e
    mol = Mol()
    for i in range(n):
        ln = lines[4 + i]
        x, y, z = float(ln[0:10]), float(ln[10:20]), float(ln[20:30])
        sym = ln[31:34].strip()
        if sym not in SYMBOL_TO_Z:
            raise MolError(f"unknown element symbol {sym!r}")
        mol.add_atom(SYMBOL_TO_Z[sym], pos=(x, y, z))
    for k in range(m):
        ln = lines[4 + n + k]
        i, j, o = int(ln[0:3]) - 1, int(ln[3:6]) - 1, int(ln[6:9])
        mol.add_bond(i, j, o)
    for ln in lines[4 + n + m:]:
        if ln.startswith("M  CHG"):
            cnt = int(ln[6:9])
            for c in range(cnt):
                idx = int(ln[9 + 8 * c: 13 + 8 * c]) - 1
                chg = int(ln[13 + 8 * c: 17 + 8 * c])
                mol.atoms[idx].charge = chg
        elif ln.startswith("M  END"):
            break
    return mol


def write_sdf(mols: List[Mol], path: str, names: Optional[List[str]] = None) -> None:
    with open(path, "w") as f:
        for k, mol in enumerate(mols):
            name = names[k] if names else f"mol_{k}"
            f.write(mol_to_molblock(mol, name=name))
            f.write("$$$$\n")


def read_sdf(path_or_file: Union[str, TextIO], skip_errors: bool = True) -> Iterator[Optional[Mol]]:
    """Yield Mols from an SDF; yields None for unparsable records when
    skip_errors (mirroring RDKit supplier semantics)."""
    close = False
    if isinstance(path_or_file, str):
        f = open(path_or_file, "r")
        close = True
    else:
        f = path_or_file
    try:
        buf: List[str] = []
        for line in f:
            if line.strip() == "$$$$":
                block = "".join(buf)
                buf = []
                try:
                    yield molblock_to_mol(block)
                except (MolError, ValueError, IndexError):
                    if skip_errors:
                        yield None
                    else:
                        raise
            else:
                buf.append(line)
        if any(ln.strip() for ln in buf):
            try:
                yield molblock_to_mol("".join(buf))
            except (MolError, ValueError, IndexError):
                if skip_errors:
                    yield None
                else:
                    raise
    finally:
        if close:
            f.close()
