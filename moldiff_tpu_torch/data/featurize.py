"""Model class indices -> atoms and bonds (moldiff_tpu/data/featurize.py).

Class vocabularies (GEOM-Drug defaults):
  node types: 7 elements (C N O F P S Cl) + optional mask type      -> Kn = 8
  edge types: none + {single, double, triple, aromatic} + opt. mask -> Ke = 6
Only the decoding half is ported: sampling needs no encoder.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.graph_ops import triu_indices

GEOM_DRUG_ATOMIC_NUMBERS = (6, 7, 8, 9, 15, 16, 17)  # C N O F P S Cl
GEOM_DRUG_BOND_TYPES = (1, 2, 3, 4)  # single double triple aromatic
# GEOM-Drug atom-count statistics (reference utils/transforms.py:128)
GEOM_DRUG_SIZE_MEAN = 24.923464980477522
GEOM_DRUG_SIZE_STD = 5.516291901819105


@dataclass
class MolFeaturizer:
    """Decodes model outputs to element/position/bond arrays."""

    atomic_numbers: tuple = GEOM_DRUG_ATOMIC_NUMBERS
    mol_bond_types: tuple = GEOM_DRUG_BOND_TYPES
    use_mask_node: bool = True
    use_mask_edge: bool = True

    def __post_init__(self):
        self.num_element = len(self.atomic_numbers)
        self.num_bond_types = len(self.mol_bond_types)
        self.num_node_types = self.num_element + int(self.use_mask_node)
        # +1 for the "no bond" class 0
        self.num_edge_types = self.num_bond_types + 1 + int(self.use_mask_edge)
        self.ele_to_nodetype = {e: i for i, e in enumerate(self.atomic_numbers)}
        self.nodetype_to_ele = {i: e for i, e in enumerate(self.atomic_numbers)}

    # -- decode ---------------------------------------------------------------

    def decode_output(
        self,
        pred_node: np.ndarray,      # [n, Kn] logits
        pred_pos: np.ndarray,       # [n, 3]
        pred_halfedge: np.ndarray,  # [E, Ke] logits
    ) -> dict:
        """Model output (one molecule, unpadded) -> atom/bond arrays.

        Strips mask-class atoms (with bond reindexing) and non-bonds;
        re-symmetrizes bonds. Reference utils/transforms.py:65-122.
        """
        n = len(pred_node)

        def softmax(x):
            x = x - x.max(axis=-1, keepdims=True)
            e = np.exp(x)
            return e / e.sum(axis=-1, keepdims=True)

        pred_atom = softmax(pred_node)
        atom_type = np.argmax(pred_atom, axis=-1)
        atom_prob = np.max(pred_atom, axis=-1)
        keep_atom = atom_type < self.num_element  # mask class is last
        index_changer = None
        if not keep_atom.all():
            index_changer = -np.ones(n, dtype=np.int64)
            index_changer[keep_atom] = np.arange(keep_atom.sum())
        atom_type = atom_type[keep_atom]
        atom_prob = atom_prob[keep_atom]
        element = np.array(
            [self.nodetype_to_ele[i] for i in atom_type], dtype=np.int64
        )
        atom_pos = np.asarray(pred_pos)[keep_atom]

        if self.num_edge_types == 1:
            return {"element": element, "atom_pos": atom_pos, "atom_prob": atom_prob}

        pred_he = softmax(pred_halfedge)
        edge_type = np.argmax(pred_he, axis=-1)
        edge_prob = np.max(pred_he, axis=-1)
        is_bond = (edge_type > 0) & (edge_type <= self.num_bond_types)
        bond_type = edge_type[is_bond]
        bond_prob = edge_prob[is_bond]
        iu, ju = triu_indices(n)
        bond_index = np.stack([iu[is_bond], ju[is_bond]]).astype(np.int64)
        if index_changer is not None:
            bond_index = index_changer[bond_index]
            drop = (bond_index < 0).any(axis=0)
            bond_index = bond_index[:, ~drop]
            bond_type = bond_type[~drop]
            bond_prob = bond_prob[~drop]

        bond_type = np.concatenate([bond_type, bond_type])
        bond_prob = np.concatenate([bond_prob, bond_prob])
        bond_index = np.concatenate([bond_index, bond_index[::-1]], axis=1)
        return {
            "element": element,
            "atom_pos": atom_pos,
            "bond_type": bond_type,
            "bond_index": bond_index,
            "atom_prob": atom_prob,
            "bond_prob": bond_prob,
        }


def featurizer_from_config(cfg) -> MolFeaturizer:
    """Featurizer from a train config's ``chem``/``transform`` blocks
    (the vocabulary the reference derives in scripts/train_drug3d.py:44-50).
    Used by the sample CLI."""
    return MolFeaturizer(
        atomic_numbers=tuple(cfg.chem.atomic_numbers),
        mol_bond_types=tuple(cfg.chem.mol_bond_types),
        use_mask_node=cfg.transform.use_mask_node,
        use_mask_edge=cfg.transform.use_mask_edge,
    )
