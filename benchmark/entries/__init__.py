"""Entries: how a call reaches the system under test, one module each.

An entry module has ``CIGAR`` (whether its answers carry a CIGAR) and
``build(config, traffic, device)``, which returns an object with
``call(request) -> result`` (the timed call: the result in hand) and
``answers(request, result, positions)``: ``(score, end_query, end_ref,
cigar or None)`` at each position.
"""
