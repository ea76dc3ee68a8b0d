from textflux_torch.rendering.glyph import (  # noqa: F401
    draw_glyph_beta,
    load_font,
    draw_glyph_flexible,
    draw_glyph_strip,
    draw_glyph_polygon,
    render_glyph_multi,
    render_glyph_regions,
    insert_spaces,
)
from textflux_torch.rendering.compose import (  # noqa: F401
    extract_mask,
    choose_concat_direction,
    concat_multiline,
    concat_singleline,
    crop_multiline_result,
    crop_singleline_result,
    SINGLE_LINE_STRIP_RATIO,
)
