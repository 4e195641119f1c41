"""MIX: the diff codec and the v3 wire encode (rounds are later work)."""
