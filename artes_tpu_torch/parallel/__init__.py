from artes_tpu_torch.parallel.mesh import (make_mesh, round_up_batch,  # noqa: F401
                                           run_stream_mesh)
