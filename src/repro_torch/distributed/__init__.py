"""Distribution of the port: step plans executed with one process a rank
(``plan_exec``), fault tolerance: checkpoint cadence, failure detection,
elastic recovery and graceful preemption (``fault_tolerance``), and the
deterministic chaos harness that injects them (``chaos``), and gradient
compression with error feedback (``compression``, not wired into the
training paths, as in the reference)."""
