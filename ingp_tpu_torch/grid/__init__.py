from .occupancy import grid_init, grid_from_density
