"""Vessel-graph simulation: the growth engine of the port."""
