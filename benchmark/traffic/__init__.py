"""Traffic: one generator module per kind of call, and one data file per
mix (``<mix>.json``: the generator, the entry and their parameters)."""
