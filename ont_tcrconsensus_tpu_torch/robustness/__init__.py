"""Fault-tolerant execution layer of the port: deterministic fault
injection (:mod:`.faults`, the ``chaos`` key and ``TCR_CHAOS``), failure
classification and bounded retry with the recorder behind
``robustness_report.json`` (:mod:`.retry`), the SIGTERM/SIGINT drain to a
resumable exit (:mod:`.shutdown`), the stage watchdog (:mod:`.watchdog`),
stage-boundary conservation contracts (:mod:`.contracts`), the lock table
(:mod:`.locks`) and its runtime checks (:mod:`.lockcheck`), and the
per-job scope they share (:mod:`.jobscope`)."""
