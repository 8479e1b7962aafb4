"""Footprint identity: a copy of ``get_frames_hash`` and
``get_combined_footprint_hash`` of ``lightcurver_tpu/utilities/footprint.py``
(the hash that names the ROI task's products)."""


def get_frames_hash(frames_ids):
    """Deterministic identity of a SET of frames (order-insensitive)."""
    if len(set(frames_ids)) != len(frames_ids):
        raise ValueError("Non-unique frame ids passed to this function")
    return hash(tuple(sorted(int(i) for i in frames_ids)))


def get_combined_footprint_hash(user_config, frames_id_list):
    """Footprint identity: the frame-set hash, or with the ROI_disk star
    selection the hash of its radius, so adding frames never renames the
    products."""
    if user_config["star_selection_strategy"] != "ROI_disk":
        return get_frames_hash(frames_id_list)
    return hash(user_config["ROI_disk_radius_arcseconds"])
