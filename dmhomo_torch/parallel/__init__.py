"""Data parallelism across processes (the JAX package's ``parallel/``):
process groups, the ``('data', 'model')`` grid, the rows each rank takes,
and the flat gradient buffer reduced once per step."""
