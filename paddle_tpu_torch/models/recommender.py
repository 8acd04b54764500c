"""Personalized recommendation (``paddle_tpu/models/recommender.py``; the
reference's book ``test_recommender_system.py``): a user tower (id,
gender, age, job embeddings) and a movie tower (id embedding, summed
category embeddings, a title ``sequence_conv``), their cosine similarity
scaled to the 5-point score, the squared error, SGD.  The vocabulary
sizes are MovieLens-1M's (``dataset.movielens``)."""

from .. import dataset, layers, optimizer as opt


def build(learning_rate=0.2, max_title_len=16, max_cat_len=8):
    ml = dataset.movielens
    usr = layers.data("user_id", shape=[1], dtype="int64")
    gender = layers.data("gender_id", shape=[1], dtype="int64")
    age = layers.data("age_id", shape=[1], dtype="int64")
    job = layers.data("job_id", shape=[1], dtype="int64")
    mov = layers.data("movie_id", shape=[1], dtype="int64")
    category = layers.data("category_id", shape=[max_cat_len], dtype="int64",
                           lod_level=1)
    title = layers.data("movie_title", shape=[max_title_len], dtype="int64",
                        lod_level=1)
    score = layers.data("score", shape=[1], dtype="float32")

    def tower_fc(emb):
        return layers.fc(input=emb, size=32)

    usr_emb = layers.embedding(input=usr, size=[ml.MAX_USER + 1, 32])
    usr_gender = layers.embedding(input=gender, size=[ml.NUM_GENDER, 16])
    usr_age = layers.embedding(input=age, size=[ml.NUM_AGE, 16])
    usr_job = layers.embedding(input=job, size=[ml.NUM_JOB, 16])
    usr_combined = layers.fc(
        input=layers.concat(
            [tower_fc(usr_emb), tower_fc(usr_gender), tower_fc(usr_age),
             tower_fc(usr_job)], axis=1,
        ),
        size=200, act="tanh",
    )

    mov_emb = layers.embedding(input=mov, size=[ml.MAX_MOVIE + 1, 32])
    cat_emb = layers.embedding(input=category, size=[ml.NUM_CATEGORY, 32])
    cat_pool = layers.sequence_pool(input=cat_emb, pool_type="sum")
    title_emb = layers.embedding(input=title, size=[ml.TITLE_VOCAB, 32])
    title_conv = layers.sequence_conv(
        input=title_emb, num_filters=32, filter_size=3, act="tanh"
    )
    title_pool = layers.sequence_pool(input=title_conv, pool_type="sum")
    mov_combined = layers.fc(
        input=layers.concat(
            [tower_fc(mov_emb), cat_pool, title_pool], axis=1
        ),
        size=200, act="tanh",
    )

    inference = layers.cos_sim(X=usr_combined, Y=mov_combined)
    scaled = layers.scale(inference, scale=5.0)
    cost = layers.square_error_cost(input=scaled, label=score)
    avg_cost = layers.mean(cost)
    optimizer = opt.SGD(learning_rate=learning_rate)
    optimizer.minimize(avg_cost)
    return {
        "feed": [usr, gender, age, job, mov, category, title, score],
        "prediction": scaled,
        "avg_cost": avg_cost,
    }
