from multiview_stitcher_torch.fusion._core import (  # noqa: F401
    calc_fusion_stack_properties,
    calc_stack_properties_from_view_properties_and_params,
    calc_stack_properties_from_volume,
    clear_device_tile_cache,
    combine_stack_props,
    func_ignore_nan_warning,
    fuse,
    fuse_np,
    get_interpolated_image,
    max_fusion,
    process_output_chunksize,
    process_output_stack_properties,
    simple_average_fusion,
    weighted_average_fusion,
)
from multiview_stitcher_torch.fusion import mv_deconv  # noqa: F401
