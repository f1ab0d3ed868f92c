"""Frozen work counters: operations and bytes from a configuration's widths and
each lane's own lengths, whatever kernel implements the work.

An operation is one multiply or one add: a product of (m, k) by (k, n) counts
2 m k n. Bytes count every input read once and every output written once, at
the interface of the work counted (weights and the lanes' rows in the
configuration's compute dtype, float32 where the program keeps them so).
"""
