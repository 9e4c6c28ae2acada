"""Parallel training of the port: the parameter-server update rules,
the lowering-tier table and the emulated commit rounds."""
