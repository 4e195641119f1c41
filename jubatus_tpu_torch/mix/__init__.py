"""MIX: the diff codec, the v3 wire encode and the mixers (rounds
between server processes)."""
