from anncur_tpu_torch.data.zeshel import (  # noqa: F401
    MAX_ENT_LENGTH,
    MAX_MENT_LENGTH,
    MAX_PAIR_LENGTH,
    N_ENTS_ZESHEL,
    N_MENTS_ZESHEL,
    get_dataset_info,
    get_zeshel_world_info,
    load_entities,
    load_mentions,
)
from anncur_tpu_torch.data.tokenization import (  # noqa: F401
    create_input_label_pair,
    get_candidate_representation,
    get_context_representation,
    tokenize_entities,
    tokenize_mentions,
)
