"""Reserved BERT tokens marking mention span and entity title.

A copy of ``anncur_tpu/models/special_tokens.py``: importing that module
would run ``anncur_tpu/models/__init__.py`` and load JAX. Parity with
reference models/params.py:1-4. In the bert-base-uncased
vocab [unused0]=id 1, [unused1]=id 2, [unused2]=id 3; tokenizers built
from other vocabs resolve the tags by name.
"""

ENT_START_TAG = "[unused0]"
ENT_END_TAG = "[unused1]"
ENT_TITLE_TAG = "[unused2]"

ENT_START_ID = 1
ENT_END_ID = 2
ENT_TITLE_ID = 3

NULL_IDX = 0  # [PAD]


def check_tag_ids(vocab) -> None:
    """The encoders locate the span/title tags at the FIXED bert-base
    ids (ENT_START_ID/END/TITLE = 1/2/3) statically inside jit, while
    the representation builders insert the tags by NAME lookup. A vocab
    that maps the tag names to other ids would make w_embeds/spl_tkns
    read the wrong positions with no error — refuse it up front."""
    # allocation-free fast path: this runs once per tokenized entity
    # (100k-item corpora), so the OK case is three lookups + compares
    if (
        vocab.get(ENT_START_TAG) in (None, ENT_START_ID)
        and vocab.get(ENT_END_TAG) in (None, ENT_END_ID)
        and vocab.get(ENT_TITLE_TAG) in (None, ENT_TITLE_ID)
    ):
        return
    want = {ENT_START_TAG: ENT_START_ID, ENT_END_TAG: ENT_END_ID,
            ENT_TITLE_TAG: ENT_TITLE_ID}
    got = {t: vocab.get(t) for t in want}
    bad = {t: g for t, g in got.items() if g is not None and g != want[t]}
    if bad:
        raise ValueError(
            f"special tags must sit at the bert-base ids {want} (the "
            f"encoders read those positions statically); this vocab maps "
            f"{bad} — re-map the vocab or retrain without tag heads"
        )
