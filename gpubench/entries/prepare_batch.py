"""The entry ``prepare_batch``: host problems (dicts of dense arrays) reach
the program through its dense batch entry (``batch.py`` ``prepare_batch``:
the canonicalisation of ``api.py`` and one host-to-device copy a
field)."""


def enter(problems: list, device):
    from piqp_tpu_torch import prepare_batch

    return prepare_batch(problems, device=device)
