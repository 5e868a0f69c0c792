"""Tokenizers for the LLM stack (port of ray_tpu/llm/tokenizer.py).

The default is a byte-level tokenizer (256 byte ids + BOS/EOS/PAD) that
needs no downloaded vocab; HF tokenizers are supported when a local path
is given.
"""

from __future__ import annotations


class ByteTokenizer:
    """UTF-8 byte tokenizer: token i (< 256) is byte i; specials follow."""

    PAD = 256
    BOS = 257
    EOS = 258
    vocab_size = 259

    def __len__(self) -> int:
        return self.vocab_size

    @property
    def eos_token_id(self) -> int:
        return self.EOS

    @property
    def bos_token_id(self) -> int:
        return self.BOS

    @property
    def pad_token_id(self) -> int:
        return self.PAD

    def encode(self, text: str, *, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] + ids) if add_bos else ids

    def decode(self, ids, *, skip_special_tokens: bool = True) -> str:
        raw = bytes(i for i in ids if i < 256)
        return raw.decode("utf-8", errors="replace")


def load_tokenizer(spec: str):
    """"byte" → ByteTokenizer; anything else → local HF tokenizer path."""
    if spec == "byte":
        return ByteTokenizer()
    from transformers import AutoTokenizer  # local files only (no egress)

    return AutoTokenizer.from_pretrained(spec, local_files_only=True)
