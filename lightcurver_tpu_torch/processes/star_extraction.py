"""Source segmentation: a copy of ``_segment`` of
``lightcurver_tpu/processes/star_extraction.py``, which the PSF task's
neighbour masking calls. The rest of that module (the extraction task)
is not ported yet (ROADMAP.md queue 1, the front of the pipeline).
"""

import numpy as np
from scipy import ndimage


def _segment(image, variance_map, threshold, min_area):
    """Label the pixels above threshold * sigma; returns (labels_kept,
    seg_map), seg_map 0 on the background as sep's segmentation map."""
    sigma = np.sqrt(np.maximum(variance_map, 0.0))
    detect = image > threshold * sigma
    # 8-connectivity, as sep and the JAX package's C++ extractor label
    seg, n_raw = ndimage.label(detect, structure=np.ones((3, 3)))
    if n_raw == 0:
        return [], seg
    counts = ndimage.sum_labels(np.ones_like(seg), seg,
                                index=np.arange(1, n_raw + 1))
    kept = [lab for lab, c in zip(range(1, n_raw + 1), counts)
            if c >= min_area]
    return kept, seg
