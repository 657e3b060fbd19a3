"""Small sizes for CPU runs of the harness (tests only): the cells' own
paths and checks at a width the CPU runs in seconds, with limits for that
size. At bert-base widths the cells' own limits hold (traffic files);
here the gaps of every precision differ, so each tiny limit sits
between the program's readings at this size and the float8 / TF32
control's, as the cells' limits sit at theirs. At this width weights of
std 0.05 leave every pair's score within rounding of every other's, so
no comparison could tell one pair's answer from another's; at 0.2 they
differ by far more than the control's rounding."""

TINY_MODEL = {
    "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 128,
    "vocab_size": 1100, "max_position_embeddings": 128, "random_weight_std": 0.2,
}

TINY = {
    "ce-yugioh.fixed-c600.open": {
        "config": {**TINY_MODEL, "deployment": {"max_input_len": 16, "max_label_len": 16, "pair_pad_multiple": 32,
                                                "n_items": 300, "n_anchor_queries": 40, "n_anchor_items": 32,
                                                "train_rank": 8}},
        "params": {"rate_qps": 20.0, "batch": 4, "top_k_retvr": 20, "warmup_batches": [4, 1], "drain_s": 30,
                   "check_requests": 6, "check_anchors": 8},
        "limits": {"anchor_gap": 0.15, "cand_gap": 3e-5, "rerank_gap": 0.18, "order_gap": 0.02},
    },
    "ce-yugioh.build": {
        "config": {**TINY_MODEL, "deployment": {"max_input_len": 16, "max_label_len": 16, "pair_pad_multiple": 32,
                                                "n_items": 300, "n_anchor_queries": 40, "n_anchor_items": 32,
                                                "train_rank": 8}},
        "params": {"ment_block": 4, "ent_block": 16, "max_pairs_per_program": 256, "slab": 64,
                   "mention_blocks": 400, "check_entries": 32},
        "limits": {"score_gap": 0.13},
    },
    "ce-yugioh.adaptive-b210r8": {
        "config": {**TINY_MODEL, "deployment": {"max_input_len": 16, "max_label_len": 16, "pair_pad_multiple": 32,
                                                "n_items": 300, "n_anchor_queries": 40, "n_anchor_items": 32,
                                                "train_rank": 8}},
        "params": {"batch": 8, "pool_batches": 2, "budget": 40, "rounds": 4, "check_queries": 5},
        "limits": {"vals_gap": 0.19, "ridge_gap": 0.017, "pick_gap": 7e-5, "score_gap": 0.19, "order_gap": 0.1},
    },
    "bienc-military.dense-top64": {
        "config": {**TINY_MODEL, "deployment": {"max_input_len": 16, "n_items": 2000, "embed_dim": 64}},
        "params": {"request_mentions": 32, "batch_size": 8, "k": 16, "pool_requests": 3, "kept_rows": 2,
                   "check_mentions": 12},
        "limits": {"embed_gap": 0.23, "search_score_gap": 5e-5, "search_rank_gap": 2e-5},
    },
}
