from .channelized import ShardedChannelizedFM, make_mesh
from .generic import ShardedChain
from .mesh import init_distributed, build_mesh
from .runner import ShardedPipeline
