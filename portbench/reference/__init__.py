"""The benchmark's plain reference: seeded weight slices, a frozen copy of
the DB-PIM compression (column-balanced tile pruning, per-filter INT8 and
the FTA projection) and a float32 forward pass in plain PyTorch. Imports
neither JAX nor either package of the repository."""
