"""Kernel-variant keys.

The reference dispatches by composing a C function-name string
``{mode}{sg_gaps}{trace}{stats}{table}{vec}{profile}_{width}`` and looking it
up in parasail's runtime table (reference: src/aligner/mod.rs:289-331).
Here the same capability matrix is a typed key resolved against a Python
registry at ``build()`` time — unknown combinations raise
:class:`~parasail_rs_tpu.errors.UnknownKernel` instead of panicking.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import UnknownKernel

MODES = ("nw", "sg", "sw")
OUTPUTS = ("score", "stats", "table", "stats_table", "rowcol", "stats_rowcol", "trace")
STRATEGIES = ("striped", "scan", "diag")
WIDTHS = ("sat", "8", "16", "32", "64")


@dataclass(frozen=True)
class KernelKey:
    """Typed equivalent of the parasail function-name grammar."""

    mode: str = "nw"                 # nw | sg | sw
    free: tuple[bool, bool, bool, bool] = (False, False, False, False)  # qb, qe, db, de
    outputs: str = "score"           # one of OUTPUTS
    strategy: str = "striped"        # accepted + reported; one TPU wavefront serves all
    profile: bool = False
    width: str = "sat"

    def __post_init__(self):
        if self.mode not in MODES:
            raise UnknownKernel(f"mode {self.mode!r}")
        if self.outputs not in OUTPUTS:
            raise UnknownKernel(f"outputs {self.outputs!r}")
        if self.strategy not in STRATEGIES:
            raise UnknownKernel(f"strategy {self.strategy!r}")
        if self.width not in WIDTHS:
            raise UnknownKernel(f"width {self.width!r}")
        if self.profile and self.strategy == "diag":
            # parity: profile alignment requires striped or scan
            # (reference assert, src/aligner/mod.rs:307-310)
            raise UnknownKernel(
                "Vectorization strategy must be striped or scan for alignment "
                "with a profile."
            )

    @property
    def uses_stats(self) -> bool:
        return self.outputs in ("stats", "stats_table", "stats_rowcol")

    def parasail_name(self) -> str:
        """Render the reference's function-name string for this key
        (useful in logs and parity tests)."""
        qb, qe, db, de = self.free
        sg = ""
        if self.mode == "sg":
            qpart = {(True, True): "_qx", (True, False): "_qb", (False, True): "_qe"}.get((qb, qe), "")
            dpart = {(True, True): "_dx", (True, False): "_db", (False, True): "_de"}.get((db, de), "")
            sg = qpart + dpart
            if sg == "_qx_dx":
                sg = ""
        trace = "_trace" if self.outputs == "trace" else ""
        stats = "_stats" if self.uses_stats else ""
        table = {"table": "_table", "stats_table": "_table",
                 "rowcol": "_rowcol", "stats_rowcol": "_rowcol"}.get(self.outputs, "")
        prof = "_profile" if self.profile else ""
        return f"{self.mode}{sg}{trace}{stats}{table}_{self.strategy}{prof}_{self.width}"
