from repro_torch.graph.storage import (Graph, PartitionedGraph,
                                       build_partitioned, DeviceGraph,
                                       DenseDeviceGraph, device_graph)
from repro_torch.graph.partition import partition, partition_device, edge_cut
from repro_torch.graph.generators import (road_graph, powerlaw_graph,
                                          erdos_graph, community_graph,
                                          molecule_batch, icosahedral_mesh,
                                          make_dataset, load_dataset)
from repro_torch.graph.sampler import (SampledSubgraph, sample_capacities,
                                       sample_neighbors)

__all__ = [
    "Graph", "PartitionedGraph", "build_partitioned", "partition",
    "partition_device", "edge_cut",
    "DeviceGraph", "DenseDeviceGraph", "device_graph",
    "road_graph", "powerlaw_graph", "erdos_graph", "community_graph",
    "molecule_batch", "icosahedral_mesh", "make_dataset", "load_dataset",
    "SampledSubgraph", "sample_neighbors", "sample_capacities",
]
