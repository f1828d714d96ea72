"""Frozen work counts: the least bytes and operations a kernel, or a
whole generation, must move at a cell's shapes."""
