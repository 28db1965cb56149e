"""Cross-host serving tier of the port (DESIGN.md §8; counterpart of
``repro.serve.cluster``): RPC shard fan-out + snapshot/WAL replication —
the paper's §7.2 many-server deployment, with every node scoring on a
device (``cuda`` unless the caller asks for the CPU).

* ``protocol`` — length-prefixed, crc-checksummed frames carrying a JSON
  meta line + bit-exact packed tensors (§8.1), byte for byte the JAX
  package's, so routers and nodes of either package interoperate;
* ``shard_server`` — one process per role: ``primary`` (mutations + delta
  + persist store + the AUTHORITATIVE (term, epoch)-tagged liveness
  state), ``scorer`` (one ragged row slice of the ONE build, the only
  rows it holds on its device), ``replica`` (full follower via snapshot
  distribution + WAL shipping, promotable to primary under term fencing,
  §8.3, §8.7);
* ``client`` — pipelining ``ShardClient`` (submit/PendingReply +
  same-shard request coalescing into ``msearch`` frames, §8.8) + the
  remote ``ShardSearcher`` handles that dispatch like in-process engines;
* ``router`` — bucketed fan-out merging under server-side authority
  (epoch-validated cache), read-your-writes watermarks, deterministic
  ``failover()`` election, explicit ``DegradedResultError`` instead of
  silently truncated top-k (§8.2, §8.4, §8.7); host-only numpy;
* ``local`` — subprocess launcher for tests, the chip smoke run and
  ``launch.serve --role router``.

The contract the tests (tests/test_torch_cluster*.py) pin: RPC results are
bit-identical — ids AND scores — to the port's in-process ``QueryService``
fan-out on the same state, for any number of routers sharing the cluster,
every mutation interleaving, and across a primary failover; a cluster of
one package served through the other package's router equals the scoring
package's in-process service bit for bit.
"""

from .client import (PendingReply, RemoteDeltaEngine,      # noqa: F401
                     RemoteMainEngine, ShardClient,
                     ShardUnavailableError, wait_ready)
from .local import LocalCluster, NodeHandle                # noqa: F401
from .protocol import (RemoteError, TornFrameError,        # noqa: F401
                       build_frame)
from .router import (ClusterRouter, DegradedResultError,   # noqa: F401
                     FailoverError, Session, StaleTermError)
from .shard_server import (NotPrimaryError, PromotionError,  # noqa: F401
                           ShardServer, StaleGenerationError)
