"""Heatmaps and CAMs of the port (port of ``visualize/``)."""

from transmil_deepgraft_tpu_torch.visualize.cam import (  # noqa: F401
    CAM_METHODS,
    compute_cam,
    normalize_cam,
    score_cam,
    show_cam_on_image,
)
from transmil_deepgraft_tpu_torch.visualize.gradcam import (  # noqa: F401
    assemble_pixel_heatmap,
    classic_tile_gradcam,
    pixel_gradcam_image_mil,
)
from transmil_deepgraft_tpu_torch.visualize.heatmap import (  # noqa: F401
    ImageVisualizer,
    Visualizer,
    assemble_heatmap,
    attention_tile_scores,
    deep_feature_factorization,
    export_topk_tiles,
    gradcam_tile_scores,
    roi_mask,
    save_heatmap_jpeg,
)
