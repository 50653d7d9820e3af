"""The benchmark of gs_icp_slam_torch: `python -m slam_bench.run`."""
