"""At-least-once delivery when an attempt fails while another consumer
holds its message as a duplicate.

Two consumers can meet the same message: a rebalance hands a partition on
while its old owner is still processing the head.  The second drops it as
a duplicate and commits past it.  If the holder then fails, the message
must come back: ``ConsumerGroup.redeliver`` appends it to its partition
once more.  The stage body is driven by hand here, so the interleaving is
exact."""
import numpy as np
import pytest

import repro_torch.core as tcore
from repro_torch.core.executor import Poll, Service
from repro_torch.core.runtime import TaskContext


def _pipeline(fail):
    manager = tcore.PilotManager(devices=())
    edge = manager.submit_pilot(tcore.ComputeResource(tier="edge",
                                                      n_workers=1))
    cloud = manager.submit_pilot(tcore.ComputeResource(tier="cloud",
                                                       n_workers=2))

    def process(context, data=None):
        if fail["on"]:
            raise RuntimeError("injected consumer fault")
        return float(np.sum(data))

    pipe = tcore.EdgeToCloudPipeline(
        pilot_cloud_processing=cloud, pilot_edge=edge,
        produce_function_handler=lambda context: np.ones(3),
        process_cloud_function_handler=process)
    return manager, pipe


def _consumer(pipe, state, cid):
    ctx = TaskContext(pilot_id="cloud", tier="cloud", task_id=cid,
                      attempt=0, clock=pipe._clock)
    body = pipe._stage_body(ctx, state, len(pipe.stages) - 1, cid)
    assert isinstance(next(body), Poll)
    return body


def _finish(body):
    """Let a body complete its message: the run's one message stops it."""
    with pytest.raises(StopIteration):
        body.send(None)


@pytest.mark.parametrize("holder_fails", [True, False],
                         ids=["holder-fails", "holder-succeeds"])
def test_message_dropped_as_duplicate_survives_its_holder(holder_fails):
    fail = {"on": holder_fails}
    manager, pipe = _pipeline(fail)
    state = pipe._setup_run(1, 5.0, True)
    topic, group = state.topics[-1], state.groups[-1]
    topic.produce(np.arange(3.0), partition=0)
    head = topic.poll(0, 0, timeout_s=0)

    holder = _consumer(pipe, state, "consumer-0")
    other = _consumer(pipe, state, "consumer-1")
    assert isinstance(holder.send(head), Service)      # holds the head
    assert isinstance(other.send(head), Poll)          # drops it as a dup
    assert group.committed[0] == 1

    if holder_fails:
        with pytest.raises(RuntimeError, match="injected"):
            holder.send(None)
        # the head is back on its partition under the same id
        assert topic.end_offsets() == [2]
        again = topic.poll(0, group.committed[0], timeout_s=0)
        assert again.msg_id == head.msg_id
        fail["on"] = False
        assert isinstance(other.send(again), Service)
        _finish(other)
    else:
        _finish(holder)
        assert topic.end_offsets() == [1]
    assert state.n_processed == 1
    assert state.results == [3.0]
    assert group.committed[0] == topic.end_offsets()[0]
    manager.release_all()


def test_duplicate_released_before_its_commit_is_not_committed():
    """A duplicate whose holder has already failed and released it is not
    committed past: the head stays where the next poll finds it."""
    manager, pipe = _pipeline({"on": False})
    state = pipe._setup_run(1, 5.0, True)
    topic, group = state.topics[-1], state.groups[-1]
    topic.produce(np.arange(3.0), partition=0)
    head = topic.poll(0, 0, timeout_s=0)
    group.commit_reserved(head, set())
    assert group.committed[0] == 0
    assert not group.redeliver(head)
    assert topic.end_offsets() == [1]
    group.commit_reserved(head, {head.msg_id})
    assert group.committed[0] == 1
    manager.release_all()
