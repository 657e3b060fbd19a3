"""ZeShEL dataset registry and raw loaders.

A copy of ``anncur_tpu/data/zeshel.py`` (it imports no JAX; the port
keeps its own copy and imports nothing of the JAX package).

Parity with reference utils/zeshel_utils.py (world lists, entity/mention
counts, max lengths, file-path templates) and the raw-data loaders in
utils/data_process.py:71-167.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional, Tuple

LOGGER = logging.getLogger(__name__)

MAX_ENT_LENGTH = 128
MAX_MENT_LENGTH = 128
MAX_PAIR_LENGTH = 256

N_ENTS_ZESHEL = {
    "lego": 10076,
    "star_trek": 34430,
    "forgotten_realms": 15603,
    "yugioh": 10031,
    "american_football": 31929,
    "fallout": 16992,
    "pro_wrestling": 10133,
    "military": 104520,
    "doctor_who": 40281,
    "final_fantasy": 14044,
    "starwars": 87056,
    "world_of_warcraft": 27677,
    "coronation_street": 17809,
    "muppets": 21344,
    "ice_hockey": 28684,
    "elder_scrolls": 21712,
}

N_MENTS_ZESHEL = {
    "lego": 1199,
    "star_trek": 4227,
    "forgotten_realms": 1200,
    "yugioh": 3374,
    "american_football": 3898,
    "fallout": 3286,
    "pro_wrestling": 1392,
    "military": 13063,
    "doctor_who": 8334,
    "final_fantasy": 6041,
    "starwars": 11824,
    "world_of_warcraft": 1437,
    "coronation_street": 1464,
    "muppets": 2028,
    "ice_hockey": 2233,
    "elder_scrolls": 4275,
}

TRAIN_WORLDS = [
    "american_football",
    "doctor_who",
    "fallout",
    "final_fantasy",
    "military",
    "pro_wrestling",
    "starwars",
    "world_of_warcraft",
]
TEST_WORLDS = ["forgotten_realms", "lego", "star_trek", "yugioh"]
VALID_WORLDS = ["coronation_street", "elder_scrolls", "ice_hockey", "muppets"]


def get_zeshel_world_info() -> List[Tuple[str, str]]:
    """[(split, world)] ordered test, train, valid
    (reference: utils/zeshel_utils.py:45-55)."""
    worlds = [("test", w) for w in TEST_WORLDS]
    worlds += [("train", w) for w in TRAIN_WORLDS]
    worlds += [("valid", w) for w in VALID_WORLDS]
    return worlds


def get_dataset_info(
    data_dir: str,
    res_dir: Optional[str],
    worlds: List[Tuple[str, str]],
    n_ment: Optional[int] = 100,
) -> Dict[str, Dict[str, str]]:
    """Per-world file-path templates incl. the score-matrix naming scheme
    (reference: utils/zeshel_utils.py:58-79)."""
    datasets = {
        world: {
            "ment_file": f"{data_dir}/processed/{world_type}_worlds/{world}_mentions.jsonl",
            "ent_file": f"{data_dir}/documents/{world}.json",
            "ent_tokens_file": f"{data_dir}/tokenized_entities/{world}_128_bert_base_uncased.npy",
        }
        for world_type, world in worlds
    }
    if res_dir is not None:
        n_ments = N_MENTS_ZESHEL if n_ment is None else {d: n_ment for d in N_MENTS_ZESHEL}
        for domain, n_ents in N_ENTS_ZESHEL.items():
            if domain not in datasets:
                datasets[domain] = {}
            datasets[domain]["crossenc_ment_to_ent_scores"] = (
                f"{res_dir}/{domain}/ment_to_ent_scores_n_m_{n_ments[domain]}"
                f"_n_e_{n_ents}_all_layers_False.pkl"
            )
            datasets[domain]["crossenc_ment_and_ent_embeds"] = (
                f"{res_dir}/{domain}/ment_and_ent_embeds_n_m_{n_ments[domain]}"
                f"_n_e_{n_ents}_all_layers_False.pkl"
            )
    return datasets


# --------------------------------------------------------------------- #
# raw loaders
# --------------------------------------------------------------------- #


def load_entities(ent_file: str) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Parse entity documents JSON(L): returns (kb_id -> local id,
    [(title, text)]); lowercased (reference: utils/data_process.py:124-167)."""
    id_to_idx: Dict[str, int] = {}
    ents: List[Tuple[str, str]] = []
    with open(ent_file, encoding="utf-8") as fin:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            id_to_idx[rec["document_id"]] = len(ents)
            ents.append((rec["title"].lower(), rec["text"].lower()))
    return id_to_idx, ents


def load_mentions(
    ment_file: str, kb_id_to_local_id: Dict[str, int]
) -> List[Dict]:
    """Parse mention JSONL into BLINK-style dicts with local label ids
    (reference: utils/data_process.py:88-121)."""
    mentions = []
    with open(ment_file, encoding="utf-8") as fin:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            # primary schema: the processed BLINK files this pipeline's
            # own preprocessor (and the reference's) writes — keys
            # label_id / mention / type (reference load_mentions reads
            # record['label_id'], utils/data_process.py:106-116).
            # Fallback: raw-zeshel keys (label_document_id / text /
            # category / corpus) for unprocessed dumps.
            label_doc_id = rec.get("label_id", rec.get("label_document_id"))
            if label_doc_id not in kb_id_to_local_id:
                LOGGER.warning("mention label %s not in entity set; skipping", label_doc_id)
                continue
            mention_text = rec.get("mention", rec.get("text"))
            if mention_text is None or "context_left" not in rec:
                # raw zeshel dumps carry start_index/end_index offsets
                # into a separate documents file instead of context
                # strings; they must go through preprocess_zeshel_data
                # first (a bare KeyError here was unactionable)
                raise ValueError(
                    f"{ment_file}: record has no mention/context_left keys — "
                    "raw zeshel dumps must be converted with "
                    "anncur_tpu_torch.data.preprocess.preprocess_zeshel_data "
                    "(cli.preprocess_zeshel) before loading"
                )
            mentions.append(
                {
                    "mention": mention_text.lower(),
                    "mention_id": rec.get("mention_id"),
                    "context_left": rec["context_left"].lower(),
                    "context_right": rec["context_right"].lower(),
                    "context_doc_id": rec.get(
                        "context_doc_id", rec.get("context_document_id")
                    ),
                    "type": rec.get("type", rec.get("category")),
                    "label_id": kb_id_to_local_id[label_doc_id],
                    "world": rec.get("world", rec.get("corpus")),
                }
            )
    return mentions
