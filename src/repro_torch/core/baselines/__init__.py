"""Exact oracles and the paper's paradigm baselines (§3.2, Fig. 7), port of
``repro.core.baselines``: :mod:`bruteforce` enumerates every connected
embedding on the host with set dedup and nothing of the expansion, the
quick codes or the aggregation; :mod:`tlv` and :mod:`tlp` count the work of
think-like-a-vertex and think-like-a-pattern mining. All three are plain
host Python over sets, for small graphs."""
