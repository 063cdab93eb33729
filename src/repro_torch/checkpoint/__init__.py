"""Checksummed payload I/O (the reference's ``checkpoint/checkpointer.py``,
its payload half)."""
