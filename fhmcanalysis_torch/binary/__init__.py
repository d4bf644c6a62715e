from .isopleth import check_gibbs_duhem, combine_isopleth_grids, get_iso, iso_grid, iso_grid_body, isopleth, parameterize_mesh

__all__ = ["isopleth", "iso_grid", "iso_grid_body", "get_iso", "check_gibbs_duhem", "parameterize_mesh", "combine_isopleth_grids"]
