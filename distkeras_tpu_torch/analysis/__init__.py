"""Runtime analysis of the port: ``racecheck``, the opt-in lockset race
and deadlock detector whose lock factories every lock-bearing module of
the host parameter server builds its locks from.  The static passes
(lockcheck, modelcheck, protomodel, surfaces) are ROADMAP.md §1 item
10."""
