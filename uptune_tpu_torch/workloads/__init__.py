from .synthetic import (  # noqa: F401
    beale_device, gcc_like_records, make_host_objective,
    random_tsp_distances,
    rosenbrock_device, rosenbrock_objective, rosenbrock_space, sphere_device,
    tsp_device, tsp_objective, tsp_space)
