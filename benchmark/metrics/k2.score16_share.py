"""The share of the block kernel's score-class pairs whose result the
packed 16x2 form gave: the pairs it launched less those its fetch
recomputed through the int32 form, over every such pair of the window
(the packed ones and those the route sent to the int32 form directly);
the program's ``score16_pairs``, ``score16_reruns`` and ``score32_pairs``
counters, in percent.  A program without these counters reads nothing."""


def read(run):
    st = run.stages or {}
    packed = st.get("count.score16_pairs")
    if packed is None:
        return None
    reruns = st.get("count.score16_reruns", {"n": 0})["n"]
    direct = st.get("count.score32_pairs", {"n": 0})["n"]
    total = packed["n"] + direct
    if total <= 0:
        return None
    return 100.0 * (packed["n"] - reruns) / total
