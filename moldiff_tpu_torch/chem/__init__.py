"""First-party chemistry (copies of moldiff_tpu/chem: periodic, mol,
sanitize, smiles, sdf, bond_perception, and for evaluation smarts, the
SMARTS subset the descriptors, alerts and fr_* counters match with, and
embed, the distance-geometry conformers of eval/rmsd.py). Pure Python and
numpy."""
