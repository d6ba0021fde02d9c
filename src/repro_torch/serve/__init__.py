"""The port's serving planes: the LGRASS sparsification service
(`sparsify_service.SparsifyService`: pow2-bucketed chunks of graphs, sync,
async, donated and mesh-sharded) and the LMs' batched prefill and greedy
decode (`serve_step`)."""
