"""Fault injection and the fault-tolerance runtime of the port."""
