"""TF-IDF vectorizer, pure numpy (sklearn-compatible defaults).

A copy of ``anncur_tpu/data/tfidf.py`` (it imports no JAX).

Replaces the reference's ``sklearn.TfidfVectorizer(dtype=np.float32)``
baseline embedder (utils/data_process.py:170-195, 246-269): lowercase,
token pattern ``\\b\\w\\w+\\b``, smooth idf, l2 norm. Output feeds a torch
matmul scorer (the reference multiplies dense tf-idf matrices too).
``tests/test_torch_data.py`` holds it equal to the JAX package's.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

import numpy as np

_TOKEN_RE = re.compile(r"(?u)\b\w\w+\b")


class TfidfVectorizer:
    def __init__(self, dtype=np.float32):
        self.dtype = dtype
        self.vocabulary_: Dict[str, int] = {}
        self.idf_: np.ndarray | None = None

    @staticmethod
    def _tokenize(doc: str) -> List[str]:
        return _TOKEN_RE.findall(doc.lower())

    def fit(self, corpus: Sequence[str]) -> "TfidfVectorizer":
        vocab_set = set()
        doc_tokens = []
        for doc in corpus:
            toks = self._tokenize(doc)
            doc_tokens.append(toks)
            vocab_set.update(toks)
        self.vocabulary_ = {t: i for i, t in enumerate(sorted(vocab_set))}
        n_docs = len(corpus)
        df = np.zeros(len(self.vocabulary_), np.int64)
        for toks in doc_tokens:
            for t in set(toks):
                df[self.vocabulary_[t]] += 1
        # smooth idf: ln((1+n)/(1+df)) + 1 (sklearn default)
        self.idf_ = (np.log((1.0 + n_docs) / (1.0 + df)) + 1.0).astype(np.float64)
        return self

    def transform(self, docs: Sequence[str]) -> np.ndarray:
        """Dense (n_docs, vocab) l2-normalized tf-idf matrix."""
        assert self.idf_ is not None, "fit first"
        # accumulate directly at the target dtype: a float64 staging
        # matrix doubled peak memory at ZeShEL scale (104k entities x
        # 100k+ terms); sklearn's reference path is f32 throughout
        out = np.zeros((len(docs), len(self.vocabulary_)), self.dtype)
        for i, doc in enumerate(docs):
            for t in self._tokenize(doc):
                j = self.vocabulary_.get(t)
                if j is not None:
                    out[i, j] += 1.0
        out *= self.idf_[None, :].astype(self.dtype)
        norms = np.linalg.norm(out, axis=1, keepdims=True).astype(self.dtype)
        norms[norms == 0] = 1.0
        out /= norms
        return out

    def fit_transform(self, corpus: Sequence[str]) -> np.ndarray:
        return self.fit(corpus).transform(corpus)


def compute_ent_embeds_w_tfidf(entities) -> np.ndarray:
    """Dense tf-idf embeddings of entities [(title, text)]
    (reference: utils/data_process.py:246-269)."""
    corpus = [f"{title} {text}" for title, text in entities]
    return TfidfVectorizer().fit_transform(corpus)


def compute_ment_embeds_w_tfidf(entities, mentions: Sequence[str]) -> np.ndarray:
    """Vectorize mention strings with a tf-idf model trained on the
    entity corpus (reference: utils/data_process.py:170-195)."""
    corpus = [f"{title} {text}" for title, text in entities]
    vec = TfidfVectorizer().fit(corpus)
    return vec.transform(mentions)
