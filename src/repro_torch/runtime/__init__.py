"""The port's runtime: fault injection and the fault-tolerance runtime
(``fault``, ``faults``), and the spans and counters that a profile reads
(``spans``)."""
