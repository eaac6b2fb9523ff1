"""First-party chemistry (copies of moldiff_tpu/chem: periodic, mol,
sanitize, smiles, sdf). Pure Python and numpy."""
