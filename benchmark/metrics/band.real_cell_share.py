"""The in-band cells of the banded batches' real lengths (|i - j| <=
bandwidth, as ``roofline.band_cells`` counts them) over the cells the
banded launches' schedules swept, summed over every banded batch of the
window: the program's ``cells_band`` and ``cells_band_swept`` counters,
in percent."""


def read(run):
    st = run.stages or {}
    band, swept = st.get("count.cells_band"), st.get("count.cells_band_swept")
    if band is None or swept is None or swept["n"] <= 0:
        return None
    return 100.0 * band["n"] / swept["n"]
