"""recoded_share.stream: the share of the entropy-coded bytes that the
surgical splice re-codes, in % (last_stream_stats surgical_recoded_bytes
over surgical_entropy_bytes): the entropy work it does not spare.  Far
above the footprint's share of the restart segments, files were re-coded
whole."""


def read(rec):
    st = rec["counters"].get("stream")
    if not st or not st.get("surgical_entropy_bytes") \
            or "surgical_recoded_bytes" not in st:
        return None
    return st["surgical_recoded_bytes"] / st["surgical_entropy_bytes"] * 100.0
