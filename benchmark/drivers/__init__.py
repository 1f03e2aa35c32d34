"""Drivers: one closed or open loop of calls into the system each, named by a traffic mix."""
