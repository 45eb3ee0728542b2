"""What a generator hands the harness for one call."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    """One call's inputs.

    ``refs`` are the references; ``queries`` the query of each, or None
    when every pair shares ``query`` (a profile search; ``tag`` names
    which of the generator's queries).  ``qlens`` and ``rlens`` are the
    lengths as arrays (``qlens`` a scalar for a shared query);
    ``planted`` lists positions whose answers the check must be able to
    see (planted homologs of the query)."""

    refs: list
    rlens: np.ndarray
    qlens: np.ndarray | int
    queries: list | None = None
    query: bytes | None = None
    tag: int = -1
    planted: np.ndarray = field(default_factory=lambda: np.zeros(0, int))

    @property
    def n(self) -> int:
        return len(self.refs)

    def pair(self, p: int) -> tuple[bytes, bytes]:
        q = self.query if self.queries is None else self.queries[p]
        return q, self.refs[p]

    def cells(self) -> int:
        """Real DP cells: len(q) * len(r) summed over the pairs."""
        return int(np.sum(self.qlens * self.rlens))
