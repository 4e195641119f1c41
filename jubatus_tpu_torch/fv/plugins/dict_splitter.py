"""Dictionary longest-match splitter plugin (the port's copy of
jubatus_tpu/fv/plugins/dict_splitter.py).

The role of the reference's ux_splitter (plugin/src/fv_converter/
ux_splitter.cpp there: a trie dictionary matcher over a word list): emits
(begin, length) spans for every longest dictionary match in the text.

Config:
    {"method": "dynamic",
     "path": ".../dict_splitter.py",
     "function": "create",
     "dict_path": "/path/to/words.txt"}     # one word per line
or  {"words": ["w1", "w2", ...]}            # inline dictionary
"""

from __future__ import annotations

from typing import Dict, List, Tuple


class DictSplitter:
    def __init__(self, words):
        # character trie; True marker = word end
        self.root: Dict = {}
        for w in words:
            node = self.root
            for ch in w:
                node = node.setdefault(ch, {})
            node[""] = True

    def split(self, text: str) -> List[Tuple[int, int]]:
        spans: List[Tuple[int, int]] = []
        i = 0
        while i < len(text):
            node = self.root
            best = 0
            j = i
            while j < len(text) and text[j] in node:
                node = node[text[j]]
                j += 1
                if "" in node:
                    best = j - i
            if best:
                spans.append((i, best))
                i += best
            else:
                i += 1
        return spans


def create(params) -> DictSplitter:
    if "dict_path" in params:
        with open(params["dict_path"]) as f:
            words = [line.strip() for line in f if line.strip()]
    else:
        words = list(params.get("words", []))
    return DictSplitter(words)
