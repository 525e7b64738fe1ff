from multiview_stitcher_torch.fusion._core import (  # noqa: F401
    calc_fusion_stack_properties,
    calc_stack_properties_from_view_properties_and_params,
    calc_stack_properties_from_volume,
    combine_stack_props,
    fuse,
    process_output_chunksize,
    process_output_stack_properties,
    weighted_average_fusion,
)
