"""The pipeline's state: its host-built constants as named tensors.

The system has no weights.  What a `NarrowBandPipeline` carries from its
construction to every run is the set of constants the host designs once:
the filter bank ``h_bank`` and ``taper``; the solve matrices ``X``, ``pinv``
and ``XtX_inv``; with LTS (``alpha < 1``) the candidate pairs ``cand``
(int32), their 2x2 inverses ``Ainv`` and the mask ``cand_ok`` (bool) of
the non-degenerate ones; per window-length bucket the DFT tables (``Cf``/``Sf`` with
``Ec``/``Es``, or the stacked ``e2`` with the lag bounds ``lo``/``hi``), the
masks ``len_mask``/``lag_mask`` and the window ``lengths`` (with
``xcorr_method='fused'``: the padded Cf/Sf/Ec/Es, ``len_mask`` and per band
``hop``, ``maxstart``, ``lo``, ``hi``); and the
``bucket_inv_perm`` that restores band order.  `NarrowBandPipeline.state_dict`
names them; `state_from_numpy` turns a dict of NumPy arrays with the same
names (the JAX pipeline's constants, for example) into tensors that
`NarrowBandPipeline.load_state` takes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def state_from_numpy(d: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """NumPy arrays -> CPU tensors: floats become float32, integers int32,
    booleans stay boolean."""
    out = {}
    for k, v in d.items():
        a = np.asarray(v)
        if a.dtype == np.bool_:
            t = torch.from_numpy(a.copy())
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.from_numpy(a.astype(np.int32))
        elif np.issubdtype(a.dtype, np.floating):
            t = torch.from_numpy(a.astype(np.float32))
        else:
            raise TypeError(f"state[{k!r}] has unsupported dtype {a.dtype}")
        out[k] = t.contiguous()
    return out
