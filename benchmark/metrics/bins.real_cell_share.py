"""The real DP cells (a batch's sum of qlen * rlen) over the padded
cells the kernels were given (its B * Qp * Rp), summed over every batch
of the window: the program's ``cells_real`` and ``cells_padded``
counters, in percent."""


def read(run):
    st = run.stages or {}
    real, padded = st.get("count.cells_real"), st.get("count.cells_padded")
    if real is None or padded is None or padded["n"] <= 0:
        return None
    return 100.0 * real["n"] / padded["n"]
