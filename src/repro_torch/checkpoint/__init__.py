"""Checksummed payload I/O and the async training checkpointer (the
reference's ``checkpoint/checkpointer.py``)."""
