"""Fault tolerance: lane failure detection and scripted fault injection."""
