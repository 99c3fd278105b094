"""Utilities of the port: ``perf`` (the card's peak rates, HBM capacity,
MFU and the roofline)."""
