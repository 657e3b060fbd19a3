"""Raw ZeShEL -> BLINK-format preprocessing.

Parity with utils/preprocess_zeshel.py:20-152: converts raw zeshel
(documents/*.json + mentions/{train,val,test}.json with token offsets)
into per-split BLINK mention JSONL, then splits per world, renaming
'val' -> 'valid'.

A copy of ``anncur_tpu/data/preprocess.py`` (it imports no JAX).
"""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from typing import Dict

LOGGER = logging.getLogger(__name__)


def preprocess_zeshel_data(root_data_dir: str) -> None:
    out_dir = os.path.join(root_data_dir, "processed")
    os.makedirs(out_dir, exist_ok=True)

    documents: Dict[str, Dict] = {}
    doc_dir = os.path.join(root_data_dir, "documents")
    for doc_fname in sorted(os.listdir(doc_dir)):
        if not doc_fname.endswith(".json"):
            continue
        with open(os.path.join(doc_dir, doc_fname)) as fin:
            for line in fin:
                doc = json.loads(line.strip())
                doc_id = doc["document_id"]
                if doc_id in documents:
                    raise ValueError(f"duplicate document_id {doc_id}")
                documents[doc_id] = doc

    for split in ("train", "val", "test"):
        ment_path = os.path.join(root_data_dir, "mentions", split + ".json")
        if not os.path.exists(ment_path):
            LOGGER.warning("missing %s; skipping split", ment_path)
            continue
        blink_mentions = []
        # many mentions share a context document: split each document
        # once, not once per mention (military: 13k mentions over far
        # fewer documents — O(doc_len) per mention was pure rework)
        split_cache: Dict[str, list] = {}
        with open(ment_path) as fin:
            for line in fin:
                m = json.loads(line.strip())
                label_doc = documents[m["label_document_id"]]
                context_doc = documents[m["context_document_id"]]
                start, end = m["start_index"], m["end_index"]
                tokens = split_cache.get(m["context_document_id"])
                if tokens is None:
                    tokens = context_doc["text"].split()
                    split_cache[m["context_document_id"]] = tokens
                extracted = " ".join(tokens[start : end + 1])
                if extracted != m["text"]:
                    raise ValueError(
                        f"mention span mismatch for {m.get('mention_id')}: "
                        f"{extracted!r} != {m['text']!r}"
                    )
                blink_mentions.append(
                    {
                        "mention": extracted,
                        "mention_id": m["mention_id"],
                        "context_left": " ".join(tokens[:start]),
                        "context_right": " ".join(tokens[end + 1 :]),
                        "context_doc_id": m["context_document_id"],
                        "type": m["corpus"],
                        "label_id": m["label_document_id"],
                        "label": label_doc["text"],
                        "label_title": label_doc["title"],
                    }
                )
        out_split = "valid" if split == "val" else split
        with open(os.path.join(out_dir, out_split + ".jsonl"), "w") as fout:
            fout.write("\n".join(json.dumps(m) for m in blink_mentions))
        split_files(
            os.path.join(out_dir, out_split + ".jsonl"),
            os.path.join(out_dir, f"{out_split}_worlds"),
        )


def split_files(data_fname: str, out_dir: str) -> None:
    """Split one JSONL into per-world files
    (reference: split_files, utils/preprocess_zeshel.py:95-116)."""
    world_to_ments = defaultdict(list)
    with open(data_fname) as fin:
        for line in fin:
            if not line.strip():
                continue
            m = json.loads(line)
            world_to_ments[m["type"]].append(m)
    os.makedirs(out_dir, exist_ok=True)
    for world, ments in world_to_ments.items():
        with open(os.path.join(out_dir, f"{world}_mentions.jsonl"), "w") as fout:
            for m in ments:
                fout.write(json.dumps(m) + "\n")
