"""ChainSummary: labeled result array + aligned text rendering.

Counterpart of reference src/output/chainsummary.jl: a 3-D value
array (rows × stats × extra), row/column names and a header, rendered as the
aligned tables the reference prints for ``describe``/diagnostics
(chainsummary.jl:50-84).
"""

from __future__ import annotations

import numpy as np


class ChainSummary:
    def __init__(self, value, rownames, colnames, header: str = ""):
        value = np.asarray(value, dtype=float)
        if value.ndim == 1:
            value = value[:, None]
        if value.ndim == 2:
            value = value[:, :, None]
        self.value = value
        self.rownames = list(rownames)
        self.colnames = list(colnames)
        self.header = header
        if value.shape[0] != len(self.rownames):
            raise ValueError("rownames length mismatch")
        if value.shape[1] != len(self.colnames):
            raise ValueError("colnames length mismatch")

    def __getitem__(self, key):
        return self.value[key]

    def to_dict(self):
        """{rowname: {colname: value}} for the first slice (convenience)."""
        return {r: {c: float(self.value[i, j, 0])
                    for j, c in enumerate(self.colnames)}
                for i, r in enumerate(self.rownames)}

    def __repr__(self):
        out = []
        if self.header:
            out.append(self.header)
        for k in range(self.value.shape[2]):
            rows = [[""] + self.colnames]
            for i, r in enumerate(self.rownames):
                rows.append([r] + [f"{self.value[i, j, k]:.9g}"
                                   for j in range(len(self.colnames))])
            widths = [max(len(row[j]) for row in rows) for j in range(len(rows[0]))]
            for row in rows:
                out.append(" ".join(c.rjust(w) for c, w in zip(row, widths)))
            if self.value.shape[2] > 1:
                out.append("")
        return "\n".join(out)
