"""Ports of rpst.nn: conv blocks and RP stacks."""
