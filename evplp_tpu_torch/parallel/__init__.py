from evplp_tpu_torch.parallel.shard import (  # noqa: F401
    Mesh, make_mesh, sharded_photon_fam_frame, sharded_pt_frame)
