from .synthetic import (  # noqa: F401
    random_tsp_distances, rosenbrock_device, rosenbrock_space, tsp_device,
    tsp_space)
