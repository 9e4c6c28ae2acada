"""Parallel training of the port: the parameter-server update rules,
the lowering-tier table, the emulated commit rounds and ring attention
(sequence parallelism)."""
