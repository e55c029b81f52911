"""Global CMVN stats loaders.  Counterpart of wenet_tpu/utils/cmvn.py:
the JSON that `bin/compute_cmvn_stats.py` writes, and kaldi's stats
matrix as text or binary."""

import json

import numpy as np


def _load_json_cmvn(json_cmvn_file):
    """JSON stats: sums of each dimension and of its squares, and the
    frame count."""
    with open(json_cmvn_file) as f:
        cmvn_stats = json.load(f)
    means = np.asarray(cmvn_stats['mean_stat'], dtype=np.float64)
    variance = np.asarray(cmvn_stats['var_stat'], dtype=np.float64)
    count = cmvn_stats['frame_num']
    mean = means / count
    var = variance / count - mean * mean
    std = np.sqrt(np.maximum(var, 1.0e-20))
    return mean, 1.0 / std


def _load_kaldi_cmvn(kaldi_cmvn_file):
    """Kaldi text-format stats matrix: `[ m1..mD count  v1..vD 0 ]`
    — rows separated only by whitespace, parsed positionally by
    feat_dim."""
    with open(kaldi_cmvn_file, 'rb') as fid:
        if fid.read(2) == b'\0B':
            # binary kaldi stats: read through kaldi_io
            from wenet_tpu_torch.dataset.kaldi_io import read_mat
            stats = np.asarray(read_mat(kaldi_cmvn_file), np.float64)
            row1 = stats[0]
            row2 = stats[1]
            count = row1[-1]
            means = row1[:-1] / count
            var = row2[:-1] / count - means * means
            return means, 1.0 / np.sqrt(np.maximum(var, 1.0e-20))
    with open(kaldi_cmvn_file) as fid:
        arr = fid.read().split()
    if arr[0] != '[' or arr[-1] != ']' or arr[-2] != '0':
        raise ValueError(f'{kaldi_cmvn_file}: not a kaldi stats matrix')
    feat_dim = (len(arr) - 2 - 2) // 2
    means = np.asarray([float(x) for x in arr[1:feat_dim + 1]],
                       np.float64)
    count = float(arr[feat_dim + 1])
    var = np.asarray([float(x)
                      for x in arr[feat_dim + 2:2 * feat_dim + 2]],
                     np.float64)
    means = means / count
    var = var / count - means * means
    return means, 1.0 / np.sqrt(np.maximum(var, 1.0e-20))


def load_cmvn(cmvn_file, is_json: bool):
    """-> (mean, istd) float32 arrays of the stats in `cmvn_file`."""
    if is_json:
        mean, istd = _load_json_cmvn(cmvn_file)
    else:
        mean, istd = _load_kaldi_cmvn(cmvn_file)
    return mean.astype(np.float32), istd.astype(np.float32)
