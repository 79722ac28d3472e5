from streamingt2v_torch.ops.attention import attention, dot_product_attention  # noqa: F401
from streamingt2v_torch.ops.embedding import timestep_embedding  # noqa: F401
from streamingt2v_torch.ops.norms import group_norm, group_norm_affine, layer_norm  # noqa: F401
