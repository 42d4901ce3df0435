"""Token vocabulary (habitat VocabDict equivalent).

The R2R VLN-CE preprocessed dataset ships `instruction_vocab.word_list`
whose index 0 is the pad token and which contains an <unk> entry; episodes
carry already-tokenized integer ids, so this class mainly supports embedding
table sizing and debugging (reference habitat_extensions/task.py:84-86 via
habitat.datasets.utils.VocabDict).
"""

from __future__ import annotations

from typing import Dict, List

UNK_TOKEN = "<unk>"
PAD_TOKEN = "<pad>"
START_TOKEN = "<s>"
END_TOKEN = "</s>"


class VocabDict:
    def __init__(self, word_list: List[str]):
        self.word_list = list(word_list)
        self.word2idx_dict: Dict[str, int] = {w: i for i, w in enumerate(self.word_list)}
        self.unk_index = self.word2idx_dict.get(UNK_TOKEN)

    def __len__(self) -> int:
        return len(self.word_list)

    def word2idx(self, word: str) -> int:
        if word in self.word2idx_dict:
            return self.word2idx_dict[word]
        if self.unk_index is not None:
            return self.unk_index
        raise KeyError(f"word '{word}' not in vocab and no {UNK_TOKEN} entry")

    def idx2word(self, idx: int) -> str:
        return self.word_list[idx]

    def tokenize_and_index(self, text: str) -> List[int]:
        import re

        words = re.findall(r"\w+", text.lower())
        return [self.word2idx(w) for w in words]
