"""The entry ``stage_batch``: host problems of a stage-structured
configuration (dicts of stage blocks, as a generator's ``generate`` returns
them) reach the program through its stage batch entry (``batch.py``
``prepare_stage_batch``: the canonicalisation of ``multistage.py`` and one
host-to-device copy a field).  Only the keyword arguments of
``multistage.from_stage_blocks`` are handed over; what else a problem
holds (the chain's ``x0``) is the benchmark's."""

STAGE_KEYS = ("Pd", "Psub", "Pa", "Pc", "c", "A1", "A2", "Ag", "b", "G1", "G2", "Gg", "h_l",
              "h_u", "x_l", "x_u")


def enter(problems: list, device):
    from piqp_tpu_torch import prepare_stage_batch

    return prepare_stage_batch([{k: p[k] for k in STAGE_KEYS if k in p} for p in problems],
                               device=device)
