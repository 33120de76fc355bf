"""Frozen copies of the program's measurement arithmetic.

Each module names the file and commit it was copied from.  They are the
yardstick's own: a later change to the program's copy does not move them.
"""
