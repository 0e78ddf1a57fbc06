"""Fault-tolerant execution layer of the port: failure classification and
bounded retry with the recorder behind ``robustness_report.json``
(:mod:`.retry`), stage-boundary conservation contracts (:mod:`.contracts`)
and the per-job scope both use (:mod:`.jobscope`)."""
