"""FooPar core of the port: the process mesh, the Table-1 algebra, grids and
the paper's algorithms (DNS / SUMMA / Cannon matmul, Floyd-Warshall) on
gloo ranks, the Table-1 cost model (``costmodel``) and the tensor-parallel
matmuls of the LM (``tensor_ops``)."""
from .mesh import P, ProcessMesh, launch, spmd
from .dseq import (DSeq, reduce_d, shift_d, all_gather_d, all_to_all_d, apply_d,
                   scan_d, reduce_scatter_d, ring_shift_d, all_gather_ring_d)
from .grid import GridN, Grid2D, Grid3D, RingBcast
from .dns_matmul import dns_matmul, generic_matmul, dns_matmul_kernel
from .summa import (summa_matmul, cannon_matmul, summa_matmul_kernel,
                    cannon_matmul_kernel)
from .summa_pipelined import (summa_matmul_pipelined, cannon_matmul_25d,
                              summa_matmul_pipelined_kernel, cannon_matmul_25d_kernel)
from .floyd_warshall import (floyd_warshall, blocked_floyd_warshall,
                             floyd_warshall_reference)
