from repro_torch.data.synthetic import (SyntheticLM, dirichlet_partition,
                                        make_client_streams)
