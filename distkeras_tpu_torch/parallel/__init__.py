"""Parallel training of the port: the parameter-server update rules,
the lowering-tier table, the emulated commit rounds, the host-wire
parameter server (``transport``, ``compression``, ``host_ps``,
``sharded_ps``, ``faults``, over host trees in ``trees``) and ring
attention (sequence parallelism)."""
