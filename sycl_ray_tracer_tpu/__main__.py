from sycl_ray_tracer_tpu.utils.cli import main

raise SystemExit(main())
