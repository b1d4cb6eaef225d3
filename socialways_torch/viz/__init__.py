"""Host-side figures and videos (the JAX package's viz/): prediction
heatmaps, the toy animation, raw-track plots, the EMD / 1-NN curves and
the video overlay.  numpy in, files out; matplotlib and cv2 are imported
where they are used."""

from socialways_torch.viz.animation import ToyAnimation
from socialways_torch.viz.heatmap import (
    default_toy_hinv,
    prediction_density,
    render_preds_dir,
    render_scene,
    to_image_frame,
)
from socialways_torch.viz.stats_plots import plot_stats_curves
from socialways_torch.viz.tracks import plot_tracks
from socialways_torch.viz.video import (
    Display,
    FakeDisplay,
    parse_annotations,
    plot_prediction_metrics,
    to_pixels,
)

__all__ = ["default_toy_hinv", "prediction_density", "render_preds_dir",
           "render_scene", "to_image_frame", "ToyAnimation", "plot_tracks",
           "plot_stats_curves", "Display", "FakeDisplay",
           "parse_annotations", "plot_prediction_metrics", "to_pixels"]
