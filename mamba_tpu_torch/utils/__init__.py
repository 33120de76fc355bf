"""Utilities: ravel specs, math helpers, progress meter, numpy conversion."""
