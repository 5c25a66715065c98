"""Fault tolerance of the port: checkpoint cadence, failure detection,
elastic recovery and graceful preemption (``fault_tolerance``), and the
deterministic chaos harness that injects them (``chaos``)."""
